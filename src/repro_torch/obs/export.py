"""Prometheus text exposition of a MetricsRegistry.

Classic text format (the 0.0.4 exposition format every scraper parses):

    # TYPE pool_commits_total counter
    pool_commits_total 42
    # TYPE scrub_wall_ms histogram
    scrub_wall_ms_bucket{kind="full",le="1"} 3
    scrub_wall_ms_bucket{kind="full",le="+Inf"} 7
    scrub_wall_ms_sum{kind="full"} 12.5
    scrub_wall_ms_count{kind="full"} 7

Histogram buckets are cumulative (`le` = upper bound), as the format
requires.  Output is deterministic — metrics sorted by (name, labels),
values formatted canonically — so tests golden-diff it and a scrape
endpoint can serve it verbatim.  `write_metrics` is the --metrics-dir
launch-flag backend: one .prom text file plus a stats.json snapshot.
"""
from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry


def _fmt(v: float) -> str:
    """Canonical value formatting: integers bare, floats via repr."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in sorted(merged.items()))
    return "{" + body + "}"


def _exemplar(exemplars, i: int) -> str:
    """OpenMetrics exemplar suffix for bucket i, or '' when absent.

    Rendered as ` # {span_id="N"} value` — a scrape of a tail-latency
    bucket carries the trace span id of the exact sample that landed
    there, so a p99 commit links straight to its trace span
    (scripts/trace_check.py validates the linkage against the trace
    file).  Classic-format parsers treat the suffix as a comment, so
    the exposition stays 0.0.4-compatible.
    """
    if not exemplars or exemplars[i] is None:
        return ""
    eid, v = exemplars[i]
    return f' # {{span_id="{eid}"}} {_fmt(float(v))}'


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render the registry in the Prometheus text exposition format."""
    lines = []
    typed: set = set()
    for name, labels, m in registry.collect():
        kind = ("counter" if isinstance(m, Counter)
                else "gauge" if isinstance(m, Gauge) else "histogram")
        if name not in typed:
            lines.append(f"# TYPE {name} {kind}")
            typed.add(name)
        if isinstance(m, (Counter, Gauge)):
            lines.append(f"{name}{_labels(labels)} {_fmt(m.value)}")
            continue
        cum = 0
        ex = getattr(m, "exemplars", None)
        for i, (edge, c) in enumerate(zip(m.edges, m.counts)):
            cum += c
            lines.append(f"{name}_bucket"
                         f"{_labels(labels, {'le': _fmt(edge)})} {cum}"
                         f"{_exemplar(ex, i)}")
        lines.append(f"{name}_bucket"
                     f"{_labels(labels, {'le': '+Inf'})} {m.count}"
                     f"{_exemplar(ex, len(m.edges))}")
        lines.append(f"{name}_sum{_labels(labels)} {_fmt(m.sum)}")
        lines.append(f"{name}_count{_labels(labels)} {m.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_metrics(registry: MetricsRegistry, metrics_dir: str, *,
                  prefix: str = "pool",
                  stats: Optional[dict] = None) -> dict:
    """Write <prefix>.prom (+ optional <prefix>.stats.json) into
    `metrics_dir`; returns the paths written."""
    os.makedirs(metrics_dir, exist_ok=True)
    out = {}
    prom = os.path.join(metrics_dir, f"{prefix}.prom")
    with open(prom, "w") as f:
        f.write(prometheus_text(registry))
    out["prom"] = prom
    if stats is not None:
        sj = os.path.join(metrics_dir, f"{prefix}.stats.json")
        with open(sj, "w") as f:
            json.dump(stats, f, indent=1, default=str)
        out["stats"] = sj
    return out


def serve_metrics(registry: MetricsRegistry, port: int = 0,
                  host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Serve `prometheus_text(registry)` over HTTP on a daemon thread.

    This is the live scrape endpoint behind the launchers'
    --metrics-port flag.  Stdlib-only and jax-free: the handler renders
    the registry fresh per GET (a dict walk over host floats), so it
    can run beside a busy commit loop without touching device state.
    Returns the running server; the bound port is
    `server.server_address[1]` (pass port=0 to let the OS pick, as the
    smoke tests do) and `server.shutdown()` stops it.
    """
    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            body = prometheus_text(registry).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):   # quiet: the launcher owns stdout
            pass

    server = ThreadingHTTPServer((host, port), _Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="metrics-scrape")
    thread.start()
    return server
