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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import utils
from repro_torch.configs.base import ProtectConfig
from repro_torch.dist.sharding import P, ZoneMesh
from repro_torch.pool import Pool

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


def initial_state(n_words: int, seed: int, device) -> torch.Tensor:
    """The reference's `_initial_host_state` made on `device`: a Weyl-style
    integer mix, (idx * 2654435761 + seed * 97 + 1) mod 1000003, as f32
    over 1000.  The reference mixes in uint64; int64 holds the same values
    while n_words < 2^63 / 2654435761 (3.47e9 words).  The residue is below
    2^24, so its f32 is exact, and the division is one IEEE rounding (by a
    device tensor: PyTorch multiplies by the reciprocal when the divisor is
    a host scalar)."""
    if n_words >= (1 << 63) // _MIX:
        raise ValueError(f"{n_words} words overflow the int64 mix")
    x = torch.arange(n_words, dtype=torch.int64, device=device)
    x.mul_(_MIX).add_(int(seed) * 97 + 1).remainder_(_MOD)
    return x.to(torch.float32) / torch.tensor(1000.0, device=device)


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
    `device` (the card unless the caller asks for the CPU)."""

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
        state = {"w": initial_state(self.n_words, self.seed, self.device)}
        self.pool = Pool.open(state, self.specs, mesh=mesh, config=config,
                              device=self.device,
                              straggler_policy=straggler_policy)
        self.t = 0

    # -- traffic ----------------------------------------------------------------

    def bias(self, t: int) -> np.float32:
        return np.float32(t % PERIOD) * STEP_BIAS

    def next_state(self) -> dict:
        """Step t's new state from the pool's live state."""
        return {"w": fma(self.pool.state["w"], GAIN, self.bias(self.t))}

    def traffic_step(self) -> bool:
        """One commit of traffic; waits for the device (latency
        measurements want the whole commit on the clock) and returns the
        commit verdict."""
        ok = self.pool.commit(self.next_state(), data_cursor=self.t)
        sync(self.device)
        self.t += 1
        return bool(ok)

    # -- snapshot / restore / rescale -------------------------------------------

    def snapshot(self) -> dict:
        """Host copy of (state, t): the checkpoint tier's stand-in."""
        self.pool.flush()
        return {"t": self.t,
                "state": utils.tree_map(lambda x: x.cpu(), self.pool.state)}

    def restore(self, snap: dict) -> None:
        """Re-arm from a snapshot: fresh protection over restored bytes
        (the budget-exhausted path's checkpoint + re-protect)."""
        self.t = int(snap["t"])
        self.pool.init(snap["state"])

    def replay_to(self, t_target: int) -> None:
        """Deterministically re-run traffic up to step `t_target`."""
        while self.t < t_target:
            self.traffic_step()

    def rescale(self, shape) -> None:
        """Elastic resize under traffic: (data, model) mesh shape."""
        new_mesh = ZoneMesh(tuple(shape), ("data", "model"))
        self.pool = self.pool.rescale(new_mesh)
        self.mesh = new_mesh

    # -- endings ----------------------------------------------------------------

    def final_host(self) -> dict:
        """Flushed host copy of the state (the golden-diff operand)."""
        self.pool.flush()
        return utils.tree_map(lambda x: x.cpu(), self.pool.state)

    def golden(self, n_steps: int) -> dict:
        """The fault-free reference: same seed, same steps, no chaos — run
        on a fresh pool so nothing of this run leaks in."""
        ref = PoolWorkload(self._mesh0, self.config,
                           n_bytes=self.n_words * 4, seed=self.seed,
                           device=self.device)
        for _ in range(n_steps):
            ref.traffic_step()
        return ref.final_host()
