"""Deterministic synthetic traffic over a Pool.

The golden-run bit-identity check constrains the traffic generator hard:
the state trajectory must be (a) a pure function of (seed, step), (b)
bit-identical across mesh shapes (rescale under traffic must land on the
same bytes), and (c) cheap enough that per-commit latency is dominated by
the protection stack, not the "model".  An elementwise f32 recurrence
satisfies all three: elementwise ops have no cross-shard reduction order
to vary with sharding, so resharding the state mid-run cannot perturb a
single ulp.

The recurrence is w <- fma(w, GAIN, c): the reference's jitted
`w * GAIN + c` compiles to one fused multiply-add, rounded once, and
eager PyTorch (two kernels, two roundings) would drift from it on the
first step.  `fma` computes the once-rounded result exactly on any device
from float64 operations (see its docstring).

On a zone split over processes (dist/procs.py) the workload reads and
writes its process's block (`Pool.block_state`, `commit(block=True)`):
the step is elementwise, so a block's step is the block of the global
step, and the initial state of a block starts at its global word offset.
A rescale may change the process count (`rescale(shape, procs)`): a
process outside the new mesh is a spare, holds no pool, and takes part
only in the exchanges of the world's group: the rescales, a snapshot
restored onto another mesh than it was taken on (each process that held
a block of it sends the rows the current mesh places elsewhere, the
plan of `elastic.move_views`) and the golden verdict, whose run goes on
the first mesh and whose final blocks move to the final one the same
way, so a run may end on other processes than it began on.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import utils
from repro_torch.configs.base import ProtectConfig
from repro_torch.dist import elastic, procs, sharding
from repro_torch.dist.sharding import P, ZoneMesh
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.pool import Pool

AXES = ("data", "model")

# the traffic recurrence: w <- w * GAIN + (step % PERIOD) * STEP_BIAS.
# GAIN keeps magnitudes stable over hundreds of steps; the bias term makes
# every step's output distinct (a stuck commit is visible).
GAIN = np.float32(1.0000001)
STEP_BIAS = np.float32(1e-6)
PERIOD = 7
_MIX, _MOD = 2654435761, 1000003      # the initial state's Weyl mix
FMA_CHUNK = 1 << 25                   # words a chunk of `fma` (bounds its
                                      # float64 temporaries to ~1.5 GB)


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def initial_state(n_words: int, seed: int, device,
                  offset: int = 0) -> torch.Tensor:
    """The reference's `_initial_host_state` made on `device`: a Weyl-style
    integer mix, (idx * 2654435761 + seed * 97 + 1) mod 1000003, as f32
    over 1000, for the words [offset, offset + n_words) of the state.  The
    reference mixes in uint64; int64 holds the same values while the word
    index stays under 2^63 / 2654435761 (3.47e9 words).  The residue is
    below 2^24, so its f32 is exact, and the division is one IEEE rounding
    (by a device tensor: PyTorch multiplies by the reciprocal when the
    divisor is a host scalar)."""
    if offset + n_words >= (1 << 63) // _MIX:
        raise ValueError(f"{offset + n_words} words overflow the int64 mix")
    x = torch.arange(offset, offset + n_words, dtype=torch.int64,
                     device=device)
    x.mul_(_MIX).add_(int(seed) * 97 + 1).remainder_(_MOD)
    return x.to(torch.float32) / torch.tensor(1000.0, device=device)


def block_offset(mesh: ZoneMesh, n_words: int) -> int:
    """The global word index of this process's first word of a P("data")
    state of `n_words` (0 on one process)."""
    return mesh.data_offset * (n_words // mesh.group_size)


def trees_equal(a, b) -> bool:
    """Two pytrees of tensors equal leaf by leaf, byte for byte."""
    la, lb = utils.tree_leaves(a), utils.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def agreed(mesh: ZoneMesh, flag: bool) -> bool:
    """A host verdict ANDed over the world of a split zone (this process's
    own on one process)."""
    root = procs.root_of(mesh.group)
    return bool(flag) if root is None else root.agree(flag)


def fit_procs(g: int, world: int) -> int:
    """The most processes, at most `world`, that split G data ranks into
    equal blocks."""
    return max(p for p in range(1, world + 1) if g % p == 0)


def mesh_over(shape, group=None, procs_: Optional[int] = None) -> ZoneMesh:
    """A (data, model) mesh of `shape`: on one process without a group,
    else split over the first `procs_` processes of `group`'s world (by
    default as many as divide G, `fit_procs`)."""
    if group is None:
        return ZoneMesh(tuple(shape), AXES)
    root = group.root
    k = procs_ or fit_procs(int(shape[0]), root.world)
    return sharding.split_mesh(tuple(shape), AXES, root, range(k))


def n_words(n_bytes: int, g: int) -> int:
    """A workload's word count: n_bytes of f32, at least one a rank,
    rounded up to a multiple of the zone's G ranks."""
    n = max(n_bytes // 4, g)
    return (n + g - 1) // g * g


def fma(w: torch.Tensor, gain, c) -> torch.Tensor:
    """f32 `w * gain + c` rounded once (a fused multiply-add), exactly, on
    any device.  In float64 the product of two f32 is exact (48 significant
    bits) and the sum rounds once; TwoSum recovers that rounding's error,
    and an inexact sum is moved to the odd one of the two float64 values
    around the exact one (round to odd).  Rounding that to f32 gives the
    once-rounded result, as 53 >= 24 + 2 bits."""
    g, b = float(np.float32(gain)), float(np.float32(c))
    out = torch.empty_like(w)
    for src, dst in zip(w.reshape(-1).split(FMA_CHUNK),
                        out.reshape(-1).split(FMA_CHUNK)):
        p = src.double().mul_(g)                 # exact
        s = p + b
        v = s - p
        err = (p - (s - v)).add_(b - v)          # s + err == p + c exactly
        bits = s.view(torch.int64)
        odd = torch.where((err != 0) & ((bits & 1) == 0),
                          (torch.sign(err) * torch.sign(s)).to(torch.int64),
                          0)
        dst.copy_(bits.add_(odd).view(torch.float64))
    return out


class PoolWorkload:
    """Sustained synthetic commit traffic against one protected pool, on
    `device` (the card unless the caller asks for the CPU).  On a spare of
    a split mesh `pool` is None and a traffic step only advances `t`."""

    def __init__(self, mesh: ZoneMesh, config: ProtectConfig, *,
                 n_bytes: int = 1 << 16, seed: int = 0,
                 straggler_policy=None, device=None):
        self.mesh = mesh
        self._mesh0 = mesh         # golden runs on the pre-rescale mesh
        self.config = config
        self.seed = int(seed)
        self.device = utils.resolve_device(device)
        self.n_words = n_words(n_bytes, mesh.group_size)
        self.specs = {"w": P("data")}
        self.abstract = {"w": torch.empty(self.n_words, dtype=torch.float32,
                                          device="meta")}
        # what every pool of the workload publishes into, across rescales
        self.metrics = MetricsRegistry()
        self.tracer = Tracer()
        self._pool_kw = dict(device=self.device,
                             straggler_policy=straggler_policy)
        self.pool: Optional[Pool] = None
        if not mesh.is_spare:
            self.pool = Pool(mesh, self.abstract, self.specs, config,
                             metrics=self.metrics, tracer=self.tracer,
                             **self._pool_kw)
            self.pool.init(self.initial_block(mesh), block=True)
        self.t = 0

    def initial_block(self, mesh: ZoneMesh) -> dict:
        """This process's block view of the initial state on `mesh`."""
        n = self.n_words // mesh.world
        return {"w": initial_state(n, self.seed, self.device,
                                   block_offset(mesh, self.n_words))}

    def set_tracer(self, tracer: Tracer) -> None:
        """The trace sink of this workload's pools, now and after a
        rescale."""
        self.tracer = tracer
        if self.pool is not None:
            self.pool.set_tracer(tracer)

    def agreed(self, flag: bool) -> bool:
        """A host verdict ANDed over the world's processes (`agreed`)."""
        return agreed(self.mesh, flag)

    # -- traffic ----------------------------------------------------------------

    def bias(self, t: int) -> np.float32:
        return np.float32(t % PERIOD) * STEP_BIAS

    def next_state(self) -> dict:
        """Step t's new state (this process's block) from the pool's live
        block."""
        return {"w": fma(self.pool.block_state["w"], GAIN, self.bias(self.t))}

    def traffic_step(self) -> bool:
        """One commit of traffic; waits for the device (latency
        measurements want the whole commit on the clock) and returns the
        commit verdict.  A spare only counts the step."""
        if self.pool is None:
            self.t += 1
            return True
        ok = self.pool.commit(self.next_state(), data_cursor=self.t,
                              block=True)
        sync(self.device)
        self.t += 1
        return bool(ok)

    # -- snapshot / restore / rescale -------------------------------------------

    def snapshot(self) -> dict:
        """Host copy of (state, t): the checkpoint tier's stand-in (this
        process's block, on the mesh it was taken on)."""
        if self.pool is None:
            return {"t": self.t, "state": None, "mesh": self.mesh}
        self.pool.flush()
        return {"t": self.t, "mesh": self.mesh,
                "state": utils.tree_map(lambda x: x.cpu(),
                                        self.pool.block_state)}

    def restore(self, snap: dict) -> None:
        """Re-arm from a snapshot: fresh protection over restored bytes
        (the budget-exhausted path's checkpoint + re-protect).  On a split
        zone whose mesh is no longer the snapshot's, a collective over the
        world: each process that held a block of the snapshot sends the
        rows the current mesh places elsewhere, and each member of the
        current mesh re-arms with its block (a spare of both walks the
        step only)."""
        self.t = int(snap["t"])
        block = snap["state"]
        if snap["mesh"] is not self.mesh and self.mesh.group is not None:
            block = elastic.move_views(block, self.specs, snap["mesh"],
                                       self.mesh, self.abstract, self.device)
        if self.pool is not None:
            self.pool.init(block, block=True)

    def replay_to(self, t_target: int) -> None:
        """Deterministically re-run traffic up to step `t_target`."""
        while self.t < t_target:
            self.traffic_step()

    def rescale(self, shape, procs_: Optional[int] = None) -> None:
        """Elastic resize under traffic: (data, model) mesh shape, over
        `procs_` processes of a split zone's world (its group's when None);
        a one-process workload stays on one."""
        group = self.mesh.group
        if group is None:
            if procs_ not in (None, 1):
                raise ValueError(
                    f"a rescale onto {procs_} processes needs a zone split "
                    "over processes; this workload runs on one")
            new_mesh = ZoneMesh(tuple(shape), AXES)
        else:
            new_mesh = mesh_over(shape, group, procs_ or group.world)
        if self.pool is not None:
            self.pool = self.pool.rescale(new_mesh)
        else:
            self.pool = Pool.join(self.mesh, new_mesh, self.abstract,
                                  self.specs, self.config,
                                  metrics=self.metrics, tracer=self.tracer,
                                  **self._pool_kw)
        self.mesh = new_mesh

    # -- endings ----------------------------------------------------------------

    def final_host(self) -> Optional[dict]:
        """Flushed host copy of the state (this process's block; None on a
        spare): the golden-diff operand."""
        if self.pool is None:
            return None
        self.pool.flush()
        return utils.tree_map(lambda x: x.cpu(), self.pool.block_state)

    def golden(self, n_steps: int) -> Optional[dict]:
        """The fault-free reference: same seed, same steps, no chaos — run
        on a fresh pool on the first mesh and its processes, so nothing of
        this run leaks in; this process's block of it on the current mesh
        (None on a spare), its final blocks moved there as a restore moves
        a snapshot's."""
        ref = PoolWorkload(self._mesh0, self.config,
                           n_bytes=self.n_words * 4, seed=self.seed,
                           device=self.device)
        for _ in range(n_steps):
            ref.traffic_step()
        out = ref.final_host()
        if self._mesh0 is not self.mesh and self.mesh.group is not None:
            out = elastic.move_views(out, self.specs, self._mesh0, self.mesh,
                                     self.abstract, self.device)
            out = None if out is None else utils.tree_map(
                lambda x: x.cpu(), out)
        return out

    def golden_exact(self, n_steps: int) -> bool:
        """This run's final state byte-equal to the golden run's: each
        process compares its own block, and the verdict is agreed over the
        world's processes (a spare's own is True)."""
        mine, want = self.final_host(), self.golden(n_steps)
        return self.agreed(mine is None or trees_equal(mine, want))
