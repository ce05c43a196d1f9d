from portbench.run import main

main()
