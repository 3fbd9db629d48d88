"""Span tracing: structured JSONL events that make a campaign replayable.

The trace vocabulary is deliberately tiny — three event shapes, one id
space:

  * point events   {"ev": "point", "kind": ..., "id": N, "ts": ..., ...}
    — one-shot facts.  Fault injections are points with kind="fault";
    their ids are the linkage currency.
  * span begin     {"ev": "begin", "kind": ..., "id": N, "ts": ..., ...}
  * span end       {"ev": "end",   "kind": ..., "id": N, "ts": ..., ...}
    — an interval (recovery solve, scrub, rescale, flush).  Recovery
    spans carry `faults=[fault ids]`, tying every injected fault to the
    recovery that resolved it — and `followups` recoveries drained from
    the re-entry queue open their own spans against the same id space,
    so a chaos campaign becomes one connected, replayable timeline.

Ids are monotonically increasing per tracer; `ts` is host
perf_counter-relative seconds (monotonic within one trace — the point
is ordering and duration, not wall-clock epoch).  With a `path`, every
event is appended to the JSONL file as it happens (crash traces stay
useful); the in-memory `events` list always accumulates, which is what
tests and `validate_events` consume.

`validate_events` is the single source of truth for trace well-formedness
— scripts/trace_check.py is a thin CLI over it:
  * every span begin has exactly one matching end (same id);
  * every fault event id is referenced by >= 1 resolving span (a
    recovery, or a scrub whose repair fixed the damage);
  * no span references an unknown fault id (no orphan links).
A span's begin carries `parent`, the id of the span of the same tracer
that was open around it (None at the top).

Layer spans (`layer(name)`) time the program's layers, and only while a
profiler records operators: each is then a `pgl.<name>` range on the
profiler's clock, beside the operators and device work it encloses, and a
row of a process-wide table (`layer_totals()`: count, total and self ms,
the enclosing layer span) that holds the latest profiling session.  The
range is an operator range: a profiler mirrors a user annotation onto the
device's timeline, where a reader of device work could take it for some.
With no profiler recording, `layer` costs one flag check and records
nothing.  Every `Tracer.span` is also a layer span of its kind.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import IO, List, Optional

import torch


class Tracer:
    """Append-only structured event stream (host-side, jax-free).

    With `rotate_lines` / `rotate_bytes`, the JSONL output is rotated
    into numbered segments (`trace-0001.jsonl`, `trace-0002.jsonl`, …
    derived from `path`) once a segment reaches either threshold, so a
    long-soak or multi-tenant run never grows one file unbounded.  A
    span may begin in one segment and end in the next — segments are a
    storage artifact, not a semantic boundary — which is why
    scripts/trace_check.py validates a rotated family as ONE logical
    event stream.  The in-memory `events` list is unaffected by
    rotation; `segments` lists the files written so far.
    """

    def __init__(self, path: Optional[str] = None, *,
                 rotate_lines: Optional[int] = None,
                 rotate_bytes: Optional[int] = None):
        assert rotate_lines is None or rotate_lines > 0
        assert rotate_bytes is None or rotate_bytes > 0
        self.path = path
        self.rotate_lines = rotate_lines
        self.rotate_bytes = rotate_bytes
        self.segments: List[str] = []
        self.events: List[dict] = []
        self._next_id = 0
        self._open: List[int] = []       # ids of the open spans, innermost last
        self._t0 = time.perf_counter()
        self._fh: Optional[IO] = None
        self._seg_lines = 0
        self._seg_bytes = 0
        if path is not None:
            self._fh = open(self._target(), "a", buffering=1)  # line-buffered

    @property
    def _rotating(self) -> bool:
        return self.rotate_lines is not None or self.rotate_bytes is not None

    def _target(self) -> str:
        if not self._rotating:
            self.segments.append(self.path)
            return self.path
        stem, ext = os.path.splitext(self.path)
        seg = f"{stem}-{len(self.segments) + 1:04d}{ext or '.jsonl'}"
        self.segments.append(seg)
        return seg

    def _maybe_rotate(self, line_bytes: int) -> None:
        if not (self._rotating and self._seg_lines > 0):
            return
        full = ((self.rotate_lines is not None
                 and self._seg_lines >= self.rotate_lines)
                or (self.rotate_bytes is not None
                    and self._seg_bytes + line_bytes > self.rotate_bytes))
        if full:
            self._fh.close()
            self._fh = open(self._target(), "a", buffering=1)
            self._seg_lines = 0
            self._seg_bytes = 0

    # -- emission ---------------------------------------------------------------

    def _write(self, event: dict) -> dict:
        self.events.append(event)
        if self._fh is not None:
            line = json.dumps(event) + "\n"
            self._maybe_rotate(len(line))
            self._fh.write(line)
            self._seg_lines += 1
            self._seg_bytes += len(line)
        return event

    def _fresh(self, ev: str, kind: str, fields: dict) -> dict:
        eid = self._next_id
        self._next_id += 1
        return {"ev": ev, "kind": kind, "id": eid,
                "ts": round(time.perf_counter() - self._t0, 6), **fields}

    def emit(self, kind: str, **fields) -> int:
        """One point event; returns its id (faults hand this to spans)."""
        return self._write(self._fresh("point", kind, fields))["id"]

    def begin(self, kind: str, **fields) -> int:
        """Open a span; close it with `end(span_id, ...)`."""
        return self._write(self._fresh("begin", kind, fields))["id"]

    def end(self, span_id: int, kind: str, **fields) -> None:
        self._write({"ev": "end", "kind": kind, "id": span_id,
                     "ts": round(time.perf_counter() - self._t0, 6),
                     **fields})

    def span(self, kind: str, **fields) -> "_Span":
        """Context manager: begin on enter, end on exit (an exception
        ends the span with error=<type> and propagates)."""
        return _Span(self, kind, fields)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class _Span:
    def __init__(self, tracer: Tracer, kind: str, fields: dict):
        self.tracer = tracer
        self.kind = kind
        self.fields = fields
        self.id: Optional[int] = None
        self.end_fields: dict = {}

    def annotate(self, **fields) -> None:
        """Attach fields to the span's end event."""
        self.end_fields.update(fields)

    def __enter__(self) -> "_Span":
        opened = self.tracer._open
        self.id = self.tracer.begin(
            self.kind, parent=opened[-1] if opened else None, **self.fields)
        opened.append(self.id)
        self._layer = layer(self.kind)
        self._layer.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.end_fields.setdefault("error", exc_type.__name__)
        try:
            self.tracer._open.remove(self.id)
            self.tracer.end(self.id, self.kind, **self.end_fields)
        finally:
            self._layer.__exit__(exc_type, exc, tb)
        return False


# -- layer spans ---------------------------------------------------------------

LAYER_PREFIX = "pgl."


# an operator-scoped range (~1 us a span under a profiler), which no
# profiler mirrors onto the device's timeline
_range = torch._C._profiler._RecordFunctionFast


def _profiler_flag():
    """The cheapest read of whether a profiler records operators: the
    autograd profiler's module flag, else the C++ query."""
    mod = getattr(torch.autograd, "profiler", None)
    if isinstance(getattr(mod, "_is_profiler_enabled", None), bool):
        return lambda: mod._is_profiler_enabled
    return torch._C._autograd._profiler_enabled


profiling = _profiler_flag()

_OFF = contextlib.nullcontext()
_table: dict = {}      # name -> [n, total ns, self ns, {parent: n}]
_stack: list = []      # open layer spans: [name, parent, start ns, child ns]
_stale = False         # a span ran with no profiler since the table's last row


def layer(name: str):
    """Context manager timing one layer of the program while a profiler
    records: a `pgl.<name>` range and a row of the table.  With no
    profiler recording: a shared no-op, and the next span under a profiler
    starts a fresh table."""
    global _stale
    if not profiling():
        _stale = True
        return _OFF
    return _Layer(name)


class _Layer:
    __slots__ = ("name", "range")

    def __init__(self, name: str):
        self.name = name
        self.range = _range(LAYER_PREFIX + name)

    def __enter__(self) -> "_Layer":
        global _stale
        if _stale:
            _table.clear()
            _stale = False
        self.range.__enter__()
        _stack.append([self.name, _stack[-1][0] if _stack else None,
                       time.perf_counter_ns(), 0])
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter_ns()
        name, parent, t0, child = _stack.pop()
        dt = t1 - t0
        if _stack:
            _stack[-1][3] += dt
        row = _table.get(name)
        if row is None:
            row = _table[name] = [0, 0, 0, {}]
        row[0] += 1
        row[1] += dt
        row[2] += dt - child
        row[3][parent] = row[3].get(parent, 0) + 1
        self.range.__exit__(exc_type, exc, tb)
        return False


def layer_totals() -> dict:
    """{name: {"n", "total_ms", "self_ms", "parent"}} over the latest
    profiling session: self is total less the child layer spans inside;
    parent is the enclosing layer span's name (the most frequent one; None
    at the top)."""
    return {name: {"n": n, "total_ms": total / 1e6, "self_ms": own / 1e6,
                   "parent": max(parents, key=parents.get)}
            for name, (n, total, own, parents) in _table.items()}


# -- validation ----------------------------------------------------------------


def validate_events(events: List[dict]) -> List[str]:
    """Check trace well-formedness; returns violations ([] = valid)."""
    bad: List[str] = []
    begun: dict = {}
    ended: set = set()
    fault_ids: set = set()
    linked: set = set()
    for i, e in enumerate(events):
        ev, eid = e.get("ev"), e.get("id")
        if ev not in ("point", "begin", "end") or eid is None:
            bad.append(f"event {i}: malformed (ev={ev!r}, id={eid!r})")
            continue
        if ev == "point":
            if e.get("kind") == "fault":
                fault_ids.add(eid)
        elif ev == "begin":
            if eid in begun:
                bad.append(f"span {eid}: double begin")
            begun[eid] = e
        else:
            if eid not in begun:
                bad.append(f"span {eid}: end without begin")
            elif eid in ended:
                bad.append(f"span {eid}: double end")
            ended.add(eid)
        # any event carrying a `faults` list is a resolver — recovery
        # spans (begin carries the ids) and repairing-scrub span ends
        linked.update(e.get("faults") or ())
    for eid, e in begun.items():
        if eid not in ended:
            bad.append(f"span {eid} ({e.get('kind')}): never ended")
    for fid in sorted(fault_ids - linked):
        bad.append(f"fault {fid}: never linked to a recovery span")
    for fid in sorted(linked - fault_ids):
        bad.append(f"recovery links unknown fault id {fid} (orphan)")
    return bad


def load_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
