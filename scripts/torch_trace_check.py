#!/usr/bin/env python
"""Offline validator for the port's chaos/pool JSONL span traces.

Checks every trace file against the well-formedness rules in
repro_torch/obs/trace.py (`validate_events` is the single source of
truth):

  * every span begin has exactly one matching end (no dangling spans —
    a crashed recovery would leave one, which is exactly the signal);
  * every fault event id is referenced by >= 1 resolving span (a
    recovery, or a scrub whose repair fixed the damage) — no fault is
    silently forgotten;
  * no span references an unknown fault id (no orphan links).

Rotated traces (obs.Tracer rotate_lines/rotate_bytes) write numbered
segments `<stem>-0001.jsonl`, `<stem>-0002.jsonl`, …; a span may begin
in one segment and end in the next, so the segments of one family are
concatenated (in index order) and validated as ONE logical event
stream.  Unrotated files are validated individually, as before.

With `--prom METRICS.prom`, the OpenMetrics exemplar suffixes the
exporter attaches to histogram buckets (` # {span_id="N"} value`) are
cross-checked against the traces: every exemplar's span id must exist
as an event id in the trace stream, so a p99 commit sample in the
metrics surface always links back to a real dispatch span — a dangling
exemplar means the metrics and trace planes disagree about what ran.

Usage:
    python scripts/torch_trace_check.py TRACE.jsonl [...]
    python scripts/torch_trace_check.py --dir TRACE_DIR    # every *.jsonl
    python scripts/torch_trace_check.py --dir TRACE_DIR --prom METRICS.prom

Exit 0 = every trace valid; exit 1 = violations (printed per file).
repro_torch.obs needs no GPU, so this runs anywhere python and torch do —
a monitoring host does not need the card.
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.obs.trace import load_jsonl, validate_events  # noqa: E402

_SEGMENT = re.compile(r"^(?P<stem>.+)-(?P<idx>\d{4})(?P<ext>\.jsonl)$")
_EXEMPLAR = re.compile(r'#\s*\{span_id="(?P<id>[^"]+)"\}')


def group_segments(paths: list) -> list:
    """Group rotated-segment paths into families.

    Returns [(display_name, [paths...])]: segments sharing a stem become
    one family sorted by index; everything else stays a singleton.
    Order follows first appearance in `paths`.
    """
    families: dict = {}
    order: list = []
    for path in paths:
        m = _SEGMENT.match(os.path.basename(path))
        key = (os.path.join(os.path.dirname(path),
                            m.group("stem") + m.group("ext"))
               if m else path)
        if key not in families:
            families[key] = []
            order.append(key)
        families[key].append(path)
    out = []
    for key in order:
        segs = sorted(families[key])
        name = key if len(segs) == 1 and segs[0] == key else (
            f"{key} [{len(segs)} segment(s)]")
        out.append((name, segs))
    return out


def check_files(paths: list) -> list:
    events = []
    for path in paths:
        try:
            events += load_jsonl(path)
        except Exception as e:  # malformed JSON is a violation, not a crash
            return [f"unreadable {path}: {e}"]
    if not events:
        return ["empty trace"]
    return validate_events(events)


def check_file(path: str) -> list:
    return check_files([path])


def check_exemplars(prom_path: str, trace_paths: list) -> list:
    """Cross-check exporter exemplars against the trace id space.

    Every ` # {span_id="N"}` suffix in the .prom text must name an id
    that exists as a trace event id; returns violations (empty = ok).
    A .prom with zero exemplar suffixes is itself a violation when this
    check was requested — it means the p99 sample lost its span link.
    """
    try:
        with open(prom_path) as f:
            text = f.read()
    except OSError as e:
        return [f"unreadable {prom_path}: {e}"]
    span_ids = [m.group("id") for m in _EXEMPLAR.finditer(text)]
    if not span_ids:
        return [f"{prom_path}: no exemplar suffixes found"]
    known = set()
    for path in trace_paths:
        try:
            for e in load_jsonl(path):
                if e.get("id") is not None:
                    known.add(str(e["id"]))
        except Exception as e:
            return [f"unreadable {path}: {e}"]
    bad = []
    for sid in span_ids:
        if sid not in known:
            bad.append(f"exemplar span_id={sid!r} matches no trace event")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torch_trace_check")
    ap.add_argument("paths", nargs="*", help="trace .jsonl files")
    ap.add_argument("--dir", default=None,
                    help="validate every *.jsonl under this directory")
    ap.add_argument("--prom", default=None,
                    help="also cross-check this OpenMetrics text file's "
                         "exemplar span ids against the trace event ids")
    args = ap.parse_args(argv)

    paths = list(args.paths)
    if args.dir:
        paths += sorted(glob.glob(os.path.join(args.dir, "*.jsonl")))
    if not paths:
        ap.error("no trace files given (pass paths or --dir)")

    rc = 0
    for name, segs in group_segments(paths):
        violations = check_files(segs)
        n = sum(len(load_jsonl(p)) for p in segs if os.path.exists(p))
        if violations:
            rc = 1
            print(f"FAIL {name} ({n} events)")
            for v in violations:
                print(f"  - {v}")
        else:
            print(f"ok   {name} ({n} events)")
    if args.prom:
        violations = check_exemplars(args.prom, paths)
        if violations:
            rc = 1
            print(f"FAIL {args.prom} (exemplar linkage)")
            for v in violations:
                print(f"  - {v}")
        else:
            print(f"ok   {args.prom} (exemplar linkage)")
    return rc


if __name__ == "__main__":
    sys.exit(main())
