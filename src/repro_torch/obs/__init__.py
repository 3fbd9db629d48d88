"""repro_torch.obs — the pool telemetry plane (a copy of the reference's).

Three cooperating pieces, all host-side: none touches a device tensor:

  * `MetricsRegistry` (obs/metrics.py) — counters / gauges /
    fixed-bucket histograms with online p50/p99.  Every `Pool` owns one;
    the scrubber and recovery paths publish into it.
  * `Tracer` (obs/trace.py) — structured JSONL span events for scrub and
    recovery; `validate_events` checks well-formedness.  Its layer spans
    (`trace.layer`, `trace.layer_totals`) time the commit and the served
    step while a profiler records.
  * `HealthReport` (obs/health.py) — green/degraded/critical from scrub
    findings, recovery history and the syndrome budget;
    `prometheus_text` (obs/export.py) renders the registry for scraping.

Entry points on a live pool: `pool.metrics`, `pool.tracer`,
`pool.stats()`, `pool.health()`.
"""
from repro_torch.obs.health import CRITICAL, DEGRADED, GREEN, HealthReport
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     LabeledRegistry, MetricsRegistry,
                                     default_buckets)
from repro_torch.obs.trace import Tracer, load_jsonl, validate_events
from repro_torch.obs.export import (prometheus_text, serve_metrics,
                                    write_metrics)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "LabeledRegistry",
    "default_buckets",
    "Tracer", "load_jsonl", "validate_events",
    "HealthReport", "GREEN", "DEGRADED", "CRITICAL",
    "prometheus_text", "serve_metrics", "write_metrics",
]
