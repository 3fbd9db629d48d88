"""Low-overhead host-side metrics registry (the telemetry plane's core).

Everything here is plain-Python host state: incrementing a counter or
observing a histogram sample is a dict lookup plus a float add — no jax
import, no device traffic, nothing that could change a compiled program.
That is the load-bearing property: the `Pool` commit path publishes into
this registry on every transaction, and the §facade invariant (zero
compiled-byte overhead, benchmarks/obs_overhead.py) only holds because
instrumentation never touches a jitted function or a device value.
Device-resident quantities (the step counter, scrub verdicts) are
published only at boundaries that already fetch them (scrub, recovery,
`pool.stats()`), never from the steady-state commit loop.

Metric vocabulary (Prometheus-style, see obs/export.py):

  * Counter   — monotone float (`inc`), e.g. pool_commits_total
  * Gauge     — last-write-wins float (`set`/`inc`), e.g. pool_window
  * Histogram — fixed log-spaced buckets with online percentile
    estimation (`observe`, `percentile`); count/sum/min/max ride along
    so the exporter can emit the classic _count/_sum series.

Labels are keyword arguments on the getter; each distinct label set is
its own child metric, so `registry.counter("scrub_runs_total",
kind="full")` and `kind="precheck"` count independently (exactly the
Prometheus data model).  Getters are idempotent — fetching an existing
(name, labels) pair returns the same object — so call sites just ask
for what they need and never pre-register anything.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def default_buckets(lo: float = 1e-3, hi: float = 1e5,
                    per_decade: int = 8) -> List[float]:
    """Log-spaced bucket upper bounds covering [lo, hi].

    The default spans 1 us .. 100 s when samples are milliseconds — wide
    enough for every wall-clock series the pool publishes — at 8 buckets
    per decade (adjacent edges ~1.33x apart, so percentile estimates
    land within ~15% of the true sample; tests pin this against numpy).
    """
    n = int(round(math.log10(hi / lo) * per_decade))
    return [lo * 10 ** (k / per_decade) for k in range(n + 1)]


class Counter:
    """Monotone counter.  `inc` only; negative increments are a bug."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        assert n >= 0, f"counters are monotone (inc {n})"
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Fixed-bucket histogram with online percentile estimation.

    `buckets` is the sorted list of bucket *upper bounds*; samples above
    the last edge land in the +Inf overflow bucket.  `percentile(q)`
    interpolates linearly inside the bucket where the q-quantile falls,
    clamped to the observed [min, max] so tight distributions don't
    smear across a whole bucket.  O(len(buckets)) per percentile call,
    O(log len(buckets)) per observe — cheap enough for per-commit use.
    """

    __slots__ = ("edges", "counts", "count", "sum", "min", "max",
                 "exemplars")

    def __init__(self, buckets: Optional[Sequence[float]] = None):
        self.edges = sorted(float(b) for b in (buckets if buckets
                                               is not None
                                               else default_buckets()))
        assert self.edges, "a histogram needs at least one bucket edge"
        self.counts = [0] * (len(self.edges) + 1)   # +1 = +Inf overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        # per-bucket last (exemplar_id, value) pair or None — the
        # OpenMetrics exemplar model: a tail-latency bucket remembers a
        # trace span id, so a p99 sample in a scrape links back to the
        # exact traced commit that produced it
        self.exemplars: List[Optional[Tuple[object, float]]] = \
            [None] * (len(self.edges) + 1)

    def observe(self, v: float, exemplar: object = None) -> None:
        v = float(v)
        i = bisect.bisect_left(self.edges, v)
        self.counts[i] += 1
        if exemplar is not None:
            self.exemplars[i] = (exemplar, v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def percentile(self, q: float) -> Optional[float]:
        """Estimate the q-th percentile (q in [0, 100]) from buckets."""
        if not self.count:
            return None
        rank = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            lo_cum, cum = cum, cum + c
            if cum >= rank:
                # interpolate within this bucket between its edges,
                # using the observed extrema as the outermost bounds
                lo = self.edges[i - 1] if i > 0 else self.min
                hi = self.edges[i] if i < len(self.edges) else self.max
                lo, hi = max(lo, self.min), min(hi, self.max)
                if hi <= lo:
                    return lo
                frac = (rank - lo_cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.max

    def summary(self) -> dict:
        return {"n": self.count,
                "p50": self.percentile(50),
                "p99": self.percentile(99),
                "mean": self.mean,
                "min": None if self.count == 0 else self.min,
                "max": None if self.count == 0 else self.max}


LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: dict) -> LabelKey:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


class MetricsRegistry:
    """One namespace of metrics; `Pool` owns one per pool.

    Thread-light: a single lock guards child creation (hooks may fire
    from checkpoint threads); the hot-path mutations themselves are
    plain float ops on the returned child object, which call sites cache
    or re-fetch (a dict hit) as they prefer.
    """

    def __init__(self):
        self._metrics: Dict[LabelKey, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, labels: dict, cls, *args):
        key = _key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(*args)
                    self._metrics[key] = m
        assert isinstance(m, cls), (
            f"metric {name!r} already registered as "
            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, labels, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        return self._get(name, labels, Histogram, buckets)

    def labeled(self, **labels) -> "LabeledRegistry":
        """A view of this registry with `labels` bound onto every metric.

        The view quacks like a registry (counter/gauge/histogram/collect/
        snapshot), so a `Pool` handed `group_registry.labeled(tenant="t3")`
        publishes every series with a `tenant="t3"` label into the shared
        parent — per-tenant namespacing without any call-site changes —
        while `collect()`/`snapshot()` on the view see only that tenant's
        slice (what the per-tenant `stats()` embeds).
        """
        return LabeledRegistry(self, labels)

    # -- read side --------------------------------------------------------------

    def collect(self) -> Iterable[Tuple[str, dict, object]]:
        """Yield (name, labels_dict, metric) sorted by (name, labels)."""
        for (name, labels), m in sorted(self._metrics.items()):
            yield name, dict(labels), m

    def snapshot(self) -> dict:
        """Host-side dict snapshot (what `pool.stats()` embeds)."""
        out: dict = {}
        for name, labels, m in self.collect():
            lkey = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            cell = out.setdefault(name, {})
            if isinstance(m, (Counter, Gauge)):
                cell[lkey] = m.value
            else:
                cell[lkey] = m.summary()
        return out


class LabeledRegistry:
    """Label-binding view over a `MetricsRegistry` (see `labeled`).

    Writes go to the parent with the bound labels merged in (explicit
    labels win on key collision is deliberately NOT supported: a bound
    label is an identity, so rebinding it from a call site is a bug and
    asserts).  Reads (`collect`/`snapshot`) filter the parent down to
    metrics carrying every bound label and strip those labels from the
    result, so a tenant's snapshot looks exactly like a private
    registry's.
    """

    def __init__(self, base: MetricsRegistry, labels: dict):
        self.base = base
        self.labels = {k: str(v) for k, v in labels.items()}

    def _merge(self, labels: dict) -> dict:
        clash = set(self.labels) & set(labels)
        assert not clash, f"label(s) {sorted(clash)} already bound"
        return {**self.labels, **labels}

    def counter(self, name: str, **labels) -> Counter:
        return self.base.counter(name, **self._merge(labels))

    def gauge(self, name: str, **labels) -> Gauge:
        return self.base.gauge(name, **self._merge(labels))

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        return self.base.histogram(name, buckets, **self._merge(labels))

    def labeled(self, **labels) -> "LabeledRegistry":
        return LabeledRegistry(self.base, self._merge(labels))

    def collect(self) -> Iterable[Tuple[str, dict, object]]:
        bound = set(self.labels.items())
        for name, labels, m in self.base.collect():
            if bound <= set(labels.items()):
                yield name, {k: v for k, v in labels.items()
                             if k not in self.labels}, m

    snapshot = MetricsRegistry.snapshot
