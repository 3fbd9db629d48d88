"""CLI: `python -m repro_torch.chaos [--smoke | --scenario NAME] [--seed N]
[--full] [--trace-dir D] [--device cpu]`.

--smoke runs one short scenario end to end (a liveness probe); the default
runs the core campaign (the six named scenarios) and prints each one's
latency and recovery summary.  It runs on the card unless `--device cpu`
is given.  Exits 1 when a scenario ends off golden or its trace fails
validation.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.chaos")
    ap.add_argument("--smoke", action="store_true",
                    help="one short scenario (a liveness probe)")
    ap.add_argument("--scenario", default=None,
                    help="run one named scenario")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="full-length runs (default: quick)")
    ap.add_argument("--trace-dir", default=None,
                    help="write each scenario's JSONL span trace here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    from repro_torch.chaos import scenarios

    quick = not args.full
    if args.smoke:
        out = scenarios.run_scenario("midwindow_scribble_loss", quick=True,
                                     seed=args.seed,
                                     trace_dir=args.trace_dir,
                                     device=args.device)
        ok = bool(out.get("golden_exact")) and not out["trace"]["violations"]
        print(json.dumps({
            "scenario": out["scenario"], "golden_exact": out["golden_exact"],
            "recoveries": len(out["recoveries"]),
            "health": out["health"]["status"],
            "trace": out["trace"]["path"],
            "trace_violations": out["trace"]["violations"]}))
        return 0 if ok else 1
    names = ([args.scenario] if args.scenario
             else [*scenarios.SCENARIOS, *scenarios.GROUP_SCENARIOS])
    rc = 0
    for name in names:
        out = scenarios.run_scenario(name, quick=quick, seed=args.seed,
                                     trace_dir=args.trace_dir,
                                     device=args.device)
        ok = bool(out.get("golden_exact")) and not out["trace"]["violations"]
        rc |= 0 if ok else 1
        print(json.dumps({
            "scenario": name, "golden_exact": ok,
            "commit_ms": out["commit_ms"],
            "recovery_ms": out["recovery_ms"],
            "health": out["health"]["status"]}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
