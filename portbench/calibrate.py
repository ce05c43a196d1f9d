"""The readings the check's limits are set from: for each seed, one run
of a cell with a short window, the program's numbers and the control's
(the reference in bfloat16 in the program's place) against the same
reference frame, in one process. One JSON line per seed, then the
largest program reading and the smallest control reading of each number:

    python3 -m portbench.calibrate --workload <cell> --seconds 2 --seeds 11 12 ...

Needs the cell's CUDA card. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json

from portbench import check
from portbench import run as pr
from portbench.harness import Benchmark


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    pr.cache_env(pr.ROOT)
    bench = Benchmark(pr.ROOT)
    lower = {k: 0.0 for k in check.NUMBERS}
    upper = {k: float("inf") for k in check.NUMBERS}
    for seed in args.seeds:
        out = pr.run(bench, args.workload, seed, args.seconds, False,
                     with_control=True)
        prog, ctl = out["numbers"], out["control"]["numbers"]
        for k in check.NUMBERS:
            lower[k] = max(lower[k], prog[k])
            upper[k] = min(upper[k], ctl[k])
        print(json.dumps(dict(seed=seed, correct=out["correct"],
                              frames=out["attempted"],
                              check_s=out["check_s"], program=prog,
                              control=ctl, control_correct=out["control"]["correct"])),
              flush=True)
    print(json.dumps(dict(workload=args.workload, seeds=len(args.seeds),
                          lower=lower, upper=upper)), flush=True)


if __name__ == "__main__":
    main()
