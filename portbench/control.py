"""The controls of the benchmark's comparisons, at a cell's own size, on
the card: each seed runs the cell as the benchmark does (a short window),
then reads the numbers compared and, in the same process, what the
control gives in the program's place.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

The control of a pool cell is the reference's syndrome stack one
transaction behind (a refresh deferred past the commit that acknowledged
it), compared where the program's stack is; of a served model, the
reference with every matrix in float8 e4m3: at each position of the same
prompts and served tokens, the token it puts first is judged in the
served one's place.  Each must come out not correct.  One JSON line a
seed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run as bench   # noqa: E402

CONTROLS = {"pool": "stale_stack", "serve": "fp8"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench.environment()
    from portbench import harness as H
    spec = H.load_spec()
    cell = H.find(spec["workloads"], args.workload, "workload")
    driver = H.load_json(H.traffic_path(cell["traffic"]))["driver"]
    for seed in args.seeds:
        ctrl, _ = bench.run(args.workload, seed, args.seconds, False,
                            fault=CONTROLS[driver],
                            t_start=time.perf_counter())
        if H.refuse_banned():
            return 4
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "control": {k: v["value"] for k, v in ctrl["checks"].items()},
            "control_correct": ctrl["correct"],
            "readings": ctrl["readings"], "metrics": ctrl["metrics"],
            "device": ctrl["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
