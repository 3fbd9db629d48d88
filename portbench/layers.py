"""The program's own layer spans over the traced part of a window, for the
per-layer readers: `repro_torch.obs.trace.layer_totals()`, which the
program fills only while a profiler records (a traced run stops its
profiler before any reader runs).  Nothing where the program records no
such span: an untraced run, or a program without layer spans."""
from __future__ import annotations


def totals() -> dict:
    """{span: {"n", "total_ms", "self_ms", "parent"}}, or {}."""
    from repro_torch.obs import trace
    read = getattr(trace, "layer_totals", None)
    return read() if read is not None else {}


def count(spans: dict, name: str) -> int:
    return spans.get(name, {}).get("n", 0)


def per(span: str, over: str):
    """`span`'s total ms over the count of `over` (None where `over` never
    ran)."""
    spans = totals()
    n = count(spans, over)
    if not n:
        return None
    return spans.get(span, {}).get("total_ms", 0.0) / n
