"""The dry run's cost model: every op a step dispatches, counted as it runs.

The counterpart of the reference's launch/hlo_cost.py and the roofline
terms of launch/hlo_analysis.py.  `CostMode` is a `TorchDispatchMode`:
under it a step runs as it always does — on the card, on the CPU, or on
`device="meta"` tensors, where it costs no memory and needs no card — and
every aten op it dispatches is counted:

  flops      2·M·N·K per matrix product (`mm`, `bmm`, `addmm`, `baddbmm`
             and what `einsum`, `matmul` and `linear` decompose to, by
             `torch.utils.flop_counter`'s formulas), plus 1 per output
             element of every other op with a floating result — the
             reference's convention (hlo_cost.py).
  hbm_bytes  operand plus result bytes of every op (an operand's bytes
             capped at its storage's, so a broadcast view is read once).
             Eager PyTorch fuses nothing, so this is the counterpart of the
             reference's `raw_hbm_bytes`; there is no fused count to
             mirror.
  ops        the ops that launch work: every op but the views and the bare
             allocations (`empty*`).
  kernels    the hand kernels, which launch through ctypes where no
             dispatch mode sees them: each entry point of kernels/ops.py
             reports its name, bytes and integer ops itself
             (kernels/cost.py), and the ops it dispatches inside (its
             outputs' allocations, the plain version on the CPU) are not
             counted.  `launches` = ops + kernel launches.
  wire       bytes of the zone collectives (dist/collectives.py), by
             hlo_analysis.py's volume conventions, as each zone rank would
             send them on a card of its own.  The reference's model
             collectives (GSPMD's all-gathers and gradient all-reduces) do
             not exist where one device holds the zone: the collective
             term counts the zone collectives only.
  peak       bytes of the storages the step allocated that were alive at
             once, at most (each storage watched with `weakref.finalize`;
             on meta `untyped_storage().nbytes()` sizes it with no
             allocation).

Eager dispatch meets every loop iteration, so no trip counts are needed.
`roofline_terms` divides a record by the H100's peaks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kcost

# -- NVIDIA H100 80GB HBM3, 700.00 W (the SXM5 card's datasheet peaks) --------
DEVICE = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS_BF16 = 989.4e12      # dense bf16 tensor FLOP/s
HBM_BW = 3.35e12                # B/s
NVLINK_BW = 450e9               # B/s a direction

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
_NO_LAUNCH = {_aten.empty.memory_format, _aten.empty_strided.default,
              _aten.empty_like.default, _aten.new_empty.default,
              _aten.new_empty_strided.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _read_bytes(t: torch.Tensor) -> int:
    """An operand's bytes, at most its storage's (a broadcast is read
    once)."""
    return min(_nbytes(t), t.untyped_storage().nbytes())


def _tensors(xs) -> list:
    """The tensors among an op's arguments or results (a list argument,
    as `cat` takes, one level down)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


# On meta an op's outputs are its operands' shapes pushed through the op's
# meta function, which for most ops runs in Python (torch._refs) and takes
# ~100 µs; the attention tiles and the layers of a long sequence repeat
# the same few thousand ops millions of times.  An op that mutates nothing
# and returns fresh tensors of meta operands is run once per key (op,
# operand dtypes, shapes and strides, other arguments); later calls get
# new empty tensors of the recorded layouts and the recorded counts.

def _meta_key(func, args, kwargs, ins):
    if not ins or func.is_view or func._schema.is_mutable \
            or not all(t.is_meta for t in ins):
        return None
    parts = [func]
    for a in (*args, *kwargs.items()):
        if isinstance(a, (tuple, list)):
            a = tuple((t.dtype, t.shape, t.stride())
                      if isinstance(t, torch.Tensor) else t for t in a)
        elif isinstance(a, torch.Tensor):
            a = (a.dtype, a.shape, a.stride())
        parts.append(a)
    try:
        return hash(tuple(parts)), tuple(parts)
    except TypeError:
        return None


def _fresh(out) -> bool:
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return all(isinstance(o, torch.Tensor) and o.is_meta for o in outs)


def _layout(out):
    one = (lambda t: (t.shape, t.stride(), t.dtype))
    if isinstance(out, torch.Tensor):
        return one(out)
    return type(out), tuple(one(t) for t in out)


def _rebuild(layout):
    def one(shape, stride, dtype):
        return torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    if isinstance(layout[0], type):
        return layout[0](one(*t) for t in layout[1])
    return one(*layout)


class CostMode(TorchDispatchMode):
    """Counts a step's flops, bytes, launches, kernels, wire bytes and
    peak while entered; see the module docstring.  `memo=False` runs every
    meta op's own meta function (the same counts, ~4x slower)."""

    def __init__(self, memo: bool = True):
        super().__init__()
        self.memo = memo
        self.flops = 0.0
        self.mm_flops = 0.0
        self.hbm_bytes = 0.0
        self.ops = 0
        self.kernels: dict = {}
        self.wire_bytes = {k: 0.0 for k in COLLECTIVES}
        self.wire_counts = {k: 0 for k in COLLECTIVES}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._paused = 0
        self._live: dict = {}
        # a meta op's outputs and counts by its operands' layouts (below)
        self._memo: dict = {}

    def __enter__(self):
        super().__enter__()
        kcost.push(self)
        return self

    def __exit__(self, *exc):
        kcost.pop(self)
        return super().__exit__(*exc)

    # -- reports from the kernels and the collectives -------------------------

    @contextlib.contextmanager
    def kernel(self, name: str, nbytes: int, int_ops: int):
        """One hand-kernel launch: recorded, and the ops dispatched inside
        left uncounted (their allocations still watched)."""
        rec = self.kernels.setdefault(
            name, {"launches": 0, "bytes": 0, "int_ops": 0})
        rec["launches"] += 1
        rec["bytes"] += int(nbytes)
        rec["int_ops"] += int(int_ops)
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def wire(self, kind: str, nbytes: float) -> None:
        # a kind outside COLLECTIVES (a split zone's process exchange)
        # gets its entry when it first reports
        self.wire_bytes[kind] = self.wire_bytes.get(kind, 0.0) + nbytes
        self.wire_counts[kind] = self.wire_counts.get(kind, 0) + 1

    # -- the dispatch ---------------------------------------------------------

    def _watch(self, outs, args) -> None:
        """Add each output's storage the first time it is seen, unless an
        operand holds it (a view, an in-place or out= op)."""
        held = {a.untyped_storage()._cdata for a in args}
        for t in outs:
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self._live or key in held:
                continue
            n = storage.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(storage, self._release, key)

    def _release(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors(args) + _tensors(kwargs.values())
        key = _meta_key(func, args, kwargs, ins) if self.memo else None
        hit = self._memo.get(key) if key is not None else None
        if hit is not None:
            out, (flops, mm, nbytes) = _rebuild(hit[0]), hit[1]
        else:
            out = func(*args, **kwargs)
        outs = _tensors(out if isinstance(out, (tuple, list)) else (out,))
        self._watch(outs, ins)
        if self._paused or func.is_view or func in _NO_LAUNCH:
            return out
        if hit is None:
            nbytes = (sum(_read_bytes(a) for a in ins)
                      + sum(_nbytes(o) for o in outs))
            formula = flop_registry.get(func.overloadpacket)
            mm = (formula(*args, **kwargs, out_val=out)
                  if formula is not None else 0)
            flops = (mm if formula is not None
                     else outs[0].numel() if outs
                     and outs[0].is_floating_point() else 0)
            if key is not None and _fresh(out):
                self._memo[key] = (_layout(out), (flops, mm, nbytes))
        self.ops += 1
        self.hbm_bytes += nbytes
        self.flops += flops
        self.mm_flops += mm
        return out

    # -- the record -----------------------------------------------------------

    @property
    def launches(self) -> int:
        return self.ops + sum(k["launches"] for k in self.kernels.values())

    def record(self) -> dict:
        """The counts as the dry run records them (zone totals)."""
        return {"flops": self.flops, "mm_flops": self.mm_flops,
                "hbm_bytes": self.hbm_bytes, "ops": self.ops,
                "launches": self.launches,
                "kernels": {k: dict(v) for k, v in
                            sorted(self.kernels.items())},
                "wire_bytes": dict(self.wire_bytes),
                "wire_counts": dict(self.wire_counts),
                "peak_bytes": self.peak_bytes}


@dataclasses.dataclass
class Roofline:
    flops: float                 # per device
    hbm_bytes: float             # per device
    wire_bytes: float            # per device
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str
    model_flops: float = 0.0     # analytic 6ND / 2ND (per device)
    useful_ratio: float = 0.0    # model_flops / counted flops

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_terms(flops: float, hbm_bytes: float, wire_bytes: float,
                   model_flops: float = 0.0) -> Roofline:
    """The three terms on one card (`DEVICE`'s peaks) and the largest."""
    ct = flops / PEAK_FLOPS_BF16
    mt = hbm_bytes / HBM_BW
    lt = wire_bytes / NVLINK_BW
    bound = max((("compute", ct), ("memory", mt), ("collective", lt)),
                key=lambda kv: kv[1])[0]
    return Roofline(
        flops=flops, hbm_bytes=hbm_bytes, wire_bytes=wire_bytes,
        compute_s=ct, memory_s=mt, collective_s=lt, bound=bound,
        model_flops=model_flops,
        useful_ratio=(model_flops / flops) if flops else 0.0)
