"""The benchmark's machinery, shared by every cell: finding a cell's
configuration, traffic mix and metric readers by name, the spans the
benchmark records around its calls into the program, the record of the
program's kernel launches, the reduction of a device trace, and the
result line.

Nothing here imports the program at module level; a driver does, after
`run.py` has put the checkout's `src` on the path.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import math
import pathlib
import re
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

# Top-level module names that may not be loaded in a run: the JAX stack and
# the JAX package the program was ported from (compared whole, so the port
# `repro_torch` is not one of them).
BANNED_MODULES = ("jax", "jaxlib", "flax", "repro")

# The program's hand-written protection kernels, by their CUDA function
# names (kernels/csrc/*.cu) as the device trace shows them.
PROTECTION_KERNELS = re.compile(
    r"\b(fletcher_pages|commit_pages|syndrome_pages|weight_words|xor_vec|"
    r"xor_scalar)\b")

SPAN_PREFIX = "pb."


# -- finding things by name ---------------------------------------------------

def load_spec(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic_path(name: str) -> pathlib.Path:
    return HERE / "traffic" / f"{name}.json"


def metric_path(name: str) -> pathlib.Path:
    """A metric's reader: `metrics/<name>.py`, or, where there is none,
    that of the name before its first dot (`kernel_roofline.serve` reads
    with `metrics/kernel_roofline.py`)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        return HERE / "metrics" / f"{name.split('.')[0]}.py"
    return path


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_module(driver: str):
    return load_module(HERE / "drivers" / f"{driver}.py",
                       f"portbench_driver_{driver}")


def cell_metrics(spec: dict, cell: str, kind: str) -> list:
    """The metrics of `kind` ("end_to_end" / "per_layer") a cell reports:
    those that list it, and those without a list whose end-to-end metric
    the cell reports."""
    e2e = [m["name"] for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return [m for m in spec["end_to_end"] if m["name"] in e2e]
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


# -- spans and counters -------------------------------------------------------

class Spans:
    """Host spans the benchmark records around its calls into the program:
    (name, start, end) on `time.perf_counter`, summed by name; in a traced
    run each is also a profiler annotation, so the trace's idle gaps can be
    put down to what the host was doing."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.total = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.traced:
            import torch
            ctx = torch.profiler.record_function(SPAN_PREFIX + name)
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.total[name] = self.total.get(name, 0.0) + dt


class Launches:
    """Each kernel launch of the program in the traced part of a window:
    entry point, its operand's shape and its syndrome count, taken at the
    hook every entry point of `repro_torch.kernels.ops` launches through
    (`kernels.cost.launch(name, x, r, pages)`), in launch order.  The
    yardstick works each launch's bytes and ops out from the shape; what
    the program itself reckons is not read."""

    def __init__(self):
        self.records = []
        self._orig = None

    def install(self) -> None:
        from repro_torch.kernels import cost
        orig, records = cost.launch, self.records

        def launch(name, x, r=1, pages=True):
            records.append((name, tuple(x.shape), int(r)))
            return orig(name, x, r, pages)
        self._cost, self._orig = cost, orig
        cost.launch = launch

    def remove(self) -> None:
        if self._orig is not None:
            self._cost.launch, self._orig = self._orig, None


# -- the device trace ---------------------------------------------------------

def _ns(event, what: str) -> int:
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{what}_us")() * 1000)


DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name: str) -> str:
    """A device op's name without its return type and argument list."""
    name = name.replace("(anonymous namespace)", "anon")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip()


def _device_op(event, dtype: str) -> bool:
    """A kernel, copy or fill that ran on the card (not an annotation the
    profiler mirrors onto the device's timeline)."""
    if not dtype.endswith("CUDA"):
        return False
    act = getattr(event, "activity_type", None)
    if act is not None:
        return str(act()) in DEVICE_ACTIVITIES
    return not event.name().startswith(SPAN_PREFIX)


def reduce_trace(events) -> dict:
    """Busy and idle time, device time by op, and idle gaps put down to the
    benchmark's innermost host span, from a profiler's raw events.  The
    window is the `pb.window` annotation."""
    device, spans, window = [], [], None
    for e in events:
        dtype = str(e.device_type())
        start = _ns(e, "start")
        dur = _ns(e, "duration")
        name = e.name()
        if _device_op(e, dtype):
            device.append((start, start + dur, name))
        elif name.startswith(SPAN_PREFIX) and not dtype.endswith("CUDA"):
            if name == SPAN_PREFIX + "window":
                window = (start, start + dur)
            else:
                spans.append((start, start + dur, name[len(SPAN_PREFIX):]))
    if window is None:
        raise RuntimeError("the trace holds no pb.window annotation")
    w0, w1 = window
    device = [(max(s, w0), min(t, w1), n) for s, t, n in device
              if t > w0 and s < w1]
    by_op, prot_ns = {}, 0
    for s, t, n in device:
        key = short_name(n)
        by_op[key] = by_op.get(key, 0) + (t - s)
        if PROTECTION_KERNELS.search(n):
            prot_ns += t - s
    # union of the device intervals, and the gaps between them
    busy, gaps, cur = 0, [], None
    for s, t, _ in sorted(device):
        if cur is None:
            cur = [s, t]
            if s > w0:
                gaps.append((w0, s))
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy += cur[1] - cur[0]
        if cur[1] < w1:
            gaps.append((cur[1], w1))
    else:
        gaps.append((w0, w1))
    # the benchmark's spans inside the window do not nest: the gap goes to
    # the one under its midpoint
    spans.sort()
    starts = [s for s, _, _ in spans]
    by_gap = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        key = (spans[i][2] if i >= 0 and spans[i][1] >= mid
               else "outside any benchmark span")
        by_gap[key] = by_gap.get(key, 0) + (g1 - g0)
    top = lambda d: [[k, v / 1e9] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
            "protection_s": prot_ns / 1e9,
            "device_ops": top(by_op), "idle_gaps": top(by_gap),
            "device_events": len(device)}


class DeviceTrace:
    """The profiler (CUPTI: CPU and CUDA activity) over the first
    `limit_s` seconds of a window, bracketed by a `pb.window` annotation,
    with `launches` recording the program's kernel launches meanwhile:
    `start()` as the window opens; `tick()` after each transaction or step,
    which stops the profiler once `limit_s` has passed and says so; and
    `finish()` once the window has closed, which stops it if the window was
    shorter and reduces the trace into `out`.  Only part of a long window
    is traced, and the reduction waits until the window has closed: the
    raw events of every aten op take seconds to read.  A driver reads its
    host clocks over the rest of the window, after the stop, where the
    profiler adds nothing."""

    def __init__(self, enabled: bool, limit_s: float, cuda: bool = True,
                 launches: "Launches" = None):
        self.enabled, self.limit_s, self.cuda = enabled, limit_s, cuda
        self.launches = launches
        self.out = {}
        self._prof = self._done = None

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = profile(activities=acts, record_shapes=False,
                             with_stack=False)
        self._prof.__enter__()
        self._mark = torch.profiler.record_function(SPAN_PREFIX + "window")
        self._mark.__enter__()
        if self.launches is not None:
            self.launches.install()
        self._t0 = time.perf_counter()

    def tick(self) -> bool:
        """True on the call that stopped the profiler."""
        if (self._prof is not None
                and time.perf_counter() - self._t0 >= self.limit_s):
            self._stop()
            return True
        return False

    def _stop(self) -> None:
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        if self.launches is not None:
            self.launches.remove()
        self._mark.__exit__(None, None, None)
        self._done, self._prof = self._prof, None
        self._done.__exit__(None, None, None)

    def finish(self) -> None:
        if self._prof is not None:
            self._stop()
        if self._done is None:
            return
        t0 = time.perf_counter()
        self.out.update(reduce_trace(
            self._done.profiler.kineto_results.events()))
        self.out["reduce_s"] = time.perf_counter() - t0
        self._done = None


# -- statistics ---------------------------------------------------------------

def percentile(values, q: float):
    """The q-th percentile by nearest rank over every sample (None for
    none)."""
    if not values:
        return None
    v = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(v)))
    return v[k - 1]


# -- the result ---------------------------------------------------------------

def loaded_banned() -> list:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(BANNED_MODULES))


def refuse_banned() -> bool:
    """True, with the names on standard error, where the process holds a
    banned module: a run that loaded one prints no result.  (The tests
    call `run.run` inside a pytest worker that other tests' imports may
    have filled, so the command checks, not `run.run`.)"""
    banned = loaded_banned()
    if banned:
        print(f"loaded in the run's process: {', '.join(banned)}",
              file=sys.stderr)
    return bool(banned)


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: dict,
                breakdown: dict = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
