"""The port's benchmark: frame time of rt64tpu_torch under a game's
per-frame host loop. Run one cell once with

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (see run.py).
"""
