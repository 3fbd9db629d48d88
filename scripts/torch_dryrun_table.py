#!/usr/bin/env python
"""Print the dry run's records as a markdown table, one row an arch.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single
    python scripts/torch_dryrun_table.py [dryrun_results_torch.json ...]

Each workload's cell reads "peak GB / rank GB (fits) / compute, memory,
collective ms, bound": the one device's peak (the zone's arguments plus
the step's own peak, on meta), each rank's argument bytes and whether
they fit one 80 GB card, and the three roofline terms per device on the
H100's peaks (launch/cost.py: NVIDIA H100 80GB HBM3, 700.00 W); a skipped
cell reads "skip".
"""
from __future__ import annotations

import json
import sys

CARD_BYTES = 80e9
WORKLOADS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def cell(r: dict) -> str:
    if r["status"] == "skip":
        return "skip"
    if r["status"] != "ok":
        return r["status"]
    m, f = r["memory"], r["roofline"]
    rank = m["argument_bytes_per_rank"]
    fits = "" if rank <= CARD_BYTES else " (no)"
    return (f"{m['peak_bytes'] / 1e9:.1f} / {rank / 1e9:.2f}{fits} / "
            f"{f['compute_s'] * 1e3:.2f}, {f['memory_s'] * 1e3:.2f}, "
            f"{f['collective_s'] * 1e3:.2f} {f['bound'][0]}")


def rows(records: list) -> list:
    by = {}
    for r in records:
        by.setdefault(r["arch"], {})[r["workload"]] = r
    out = ["| arch | " + " | ".join(WORKLOADS) + " |",
           "| --- |" + " --- |" * len(WORKLOADS)]
    for arch, cells in by.items():
        out.append(f"| {arch} | " + " | ".join(
            cell(cells[w]) if w in cells else "" for w in WORKLOADS) + " |")
    return out


def main(argv=None) -> int:
    paths = (argv if argv is not None else sys.argv[1:]) or [
        "dryrun_results_torch.json"]
    records = []
    for path in paths:
        with open(path) as f:
            records += json.load(f)
    print("\n".join(rows(records)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
