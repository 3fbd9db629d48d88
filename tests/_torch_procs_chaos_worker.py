"""The plans of tests/test_torch_procs_chaos.py: a rescale that changes
the process count, and the chaos campaign, on a zone split over
processes.

Each plan yields (phase, record) pairs; the same plan runs on one process
in the pytest process (no group: every mesh unsplit) and on each spawned
worker (`chaos_worker`, which imports no JAX: the workers never do).  A
record holds this process's place on the phase's mesh (`procs`, the
members' ranks, and `pos`, its block; None on a spare) and its pool's
fields (this process's block of ranks, with an open window's).
`check_blocks` holds every member's block byte-equal to the one-process
record, phase by phase.

`PLANTS` are divergences the code must absorb (a budget seen otherwise on
one process; a golden block flipped on one process): each run must still
agree.  `MUTATIONS` are deliberate faults a worker can be
told to make (`mutation=`), each one that the comparison (or a failed
exchange) must catch: a newcomer placed at the wrong data offset, a
leaver's rows left unsent, a block's initial state indexed from 0, the
budget fallback decided on one process alone, the golden verdict
unagreed.
"""
import copy
import os
import pickle

import numpy as np
import torch

from repro_torch import Pool, ProtectConfig
from repro_torch.chaos import scenarios, workload
from repro_torch.chaos.workload import mesh_over
from repro_torch.core.txn import Protector
from repro_torch.dist import elastic, procs, sharding
from repro_torch.dist.sharding import P
from tests._torch_procs_window_worker import fields

PLANTS = ("diverged_budget", "late_flip")
MUTATIONS = ("newcomer_offset", "leaver_unsent", "block_from_zero",
             "unagreed_budget", "unagreed_golden")
# fields every process holds whole (not a block of ranks)
WHOLE = ("log", "step", "pending", "meta")
# the W-change rescale's cases: (redundancy, window); a "grow" case walks
# inp["walks"]["grow"], the others inp["walks"][None]
CASES = {"r1_sync": (1, 1), "r3_sync": (3, 1), "r1_w4": (1, 4),
         "r3_w4": (3, 4), "grow_r1_sync": (1, 1), "grow_r3_w4": (3, 4)}


def _moved(group) -> int:
    return 0 if group is None else group.root.stats["moved_bytes"]


def place(mesh) -> dict:
    """This process's place on `mesh`: the members' ranks and its block's
    position (None on a spare; one process: (), 0)."""
    if mesh.group is None:
        return {"procs": (), "pos": 0}
    return {"procs": mesh.members,
            "pos": None if mesh.is_spare else mesh.proc_rank}


def record(pool, mesh, **extra) -> dict:
    out = place(mesh)
    out["fields"] = None if pool is None else fields(pool)
    out.update(extra)
    return out


# -- the W-change rescale -----------------------------------------------------------

def rescale_plan(group, inp, cases=tuple(CASES)):
    """For each case: a pool (mlpc, r and window as `CASES` says) opened on
    its walk's first (shape, processes), then for each later one a
    commit (held in the window when windowed) and a rescale there, with
    the bytes this process moved in it; a commit after the walk.  A spare
    of a mesh holds no pool: it takes part in the rescales only
    (`Pool.join`) and records the refusal its rank read gives."""
    specs = {k: P(*v) for k, v in inp["specs"].items()}
    states = inp["states"]
    abstract = {k: v.to("meta") for k, v in states[0].items()}
    for case in cases:
        r, window = CASES[case]
        cfg = ProtectConfig(mode="mlpc", redundancy=r, window=window,
                            block_words=inp["bw"])
        walk = inp["walks"]["grow" if case.startswith("grow") else None]
        mesh = mesh_over(walk[0][0], group, walk[0][1])
        pool = (None if mesh.is_spare else
                Pool.open(states[0], specs, mesh=mesh, config=cfg,
                          device="cpu"))
        yield f"{case}/open", record(pool, mesh)
        for i, (shape, k) in enumerate(walk[1:], start=1):
            if pool is not None:
                assert bool(pool.commit(states[i], data_cursor=i))
            yield f"{case}/commit_{i}", record(pool, mesh)
            new = mesh_over(shape, group, k)
            moved = _moved(group)
            if pool is not None:
                pool = pool.rescale(new)
            else:
                pool = Pool.join(mesh, new, abstract, specs, cfg,
                                 device="cpu")
            mesh = new
            refused = None
            if mesh.is_spare:
                try:
                    mesh.proc_rank
                except procs.SpareError as err:
                    refused = str(err)
            yield f"{case}/rescale_{i}", record(
                pool, mesh, moved=_moved(group) - moved, refused=refused)
        if pool is not None:
            assert bool(pool.commit(states[len(walk)], data_cursor=9))
        yield f"{case}/after", record(pool, mesh)


# -- the chaos campaign -------------------------------------------------------------

def _final(pools) -> dict:
    """A scenario's `final` hook: each pool's fields and its place."""
    return {name: record(p, p.mesh) for name, p in pools.items()}


def campaign_plan(group, inp, names=None):
    """The named scenarios (every quick one and the first two storm cells
    by default) on inp["meshes"] at inp["n_bytes"] bytes, each a record
    of its golden verdict, its recoveries (kind, step, verified), the
    steps this process sat out as a spare, and its final pools."""
    size = dict(quick=True, seed=inp["seed"], meshes=inp["meshes"],
                n_bytes=inp["n_bytes"], device="cpu", group=group,
                final=_final)
    jobs = []
    for name in names or (*scenarios.SCENARIOS, *scenarios.GROUP_SCENARIOS,
                          *(f"storm_r{r}_w{w}"
                            for r, w in scenarios.STORM_CELLS[:2])):
        if name.startswith("storm_"):
            r, w = (int(x[1:]) for x in name.split("_")[1:])
            jobs.append((name, lambda r=r, w=w: scenarios.run_storm_cell(
                r, w, **size)))
        else:
            kw = dict(size)
            if name in scenarios.GROUP_SCENARIOS:
                kw["n_bytes"] = inp["tenant_bytes"]
            jobs.append((name, lambda name=name, kw=kw:
                         scenarios.run_scenario(name, **kw)))
    for name, job in jobs:
        out = job()
        yield name, {
            "golden_exact": out["golden_exact"],
            "violations": out["trace"]["violations"],
            "recoveries": [
                {k: rec.get(k) for k in ("step", "kind", "verified")}
                for rec in out["recoveries"]],
            "moved": [rec["moved_bytes"] for rec in out["recoveries"]
                      if "moved_bytes" in rec],
            "spare_steps": out.get("spare_steps", []),
            "final": out["final"]}


PLANS = {"rescale": rescale_plan, "campaign": campaign_plan}


def run(plan, group, inp, **kw) -> dict:
    """{phase: record} of one plan (one process: `group` None)."""
    return dict(PLANS[plan](group, inp, **kw))


# -- plants and mutations -----------------------------------------------------------

class _Shifted(sharding.ZoneMesh):
    """A split mesh whose process takes the next process's block."""

    @property
    def data_offset(self) -> int:
        return ((self.proc_rank + 1) % self.world) * self.local_group_size


def _plant(plant, rank) -> None:
    """A divergence on process 1 that the code must absorb."""
    if rank != 1:
        return
    if plant == "diverged_budget":
        # this process alone sees the loss as within the budget
        Protector.check_budget = lambda self, ranks: None
    elif plant == "late_flip":
        real = workload.PoolWorkload.golden

        def flipped(self, n_steps):
            out = real(self, n_steps)
            if out is not None:
                out["w"].view(torch.int32)[0] ^= 1
            return out
        workload.PoolWorkload.golden = flipped


def _mutate(mutation, rank) -> None:
    """Plant `mutation` in this process (a spawned worker only)."""
    if mutation == "newcomer_offset":
        real_join = Pool.join.__func__

        def join(cls, old_mesh, new_mesh, *a, **kw):
            if not new_mesh.is_spare:
                new_mesh = copy.copy(new_mesh)
                new_mesh.__class__ = _Shifted
            return real_join(cls, old_mesh, new_mesh, *a, **kw)
        Pool.join = classmethod(join)
    elif mutation == "leaver_unsent":
        real_move = elastic.move_blocks

        def move_blocks(state, specs, old_mesh, new_mesh, *a, **kw):
            root = procs.root_of(new_mesh.group)
            if new_mesh.is_spare and not old_mesh.is_spare:
                real = root.send_recv
                root.send_recv = lambda sends, recvs, dev: real({}, recvs,
                                                                dev)
                try:
                    return real_move(state, specs, old_mesh, new_mesh, *a,
                                     **kw)
                finally:
                    del root.send_recv
            return real_move(state, specs, old_mesh, new_mesh, *a, **kw)
        elastic.move_blocks = move_blocks
    elif mutation == "block_from_zero":
        workload.block_offset = lambda mesh, n_words: 0
    elif mutation == "unagreed_budget":
        _plant("diverged_budget", rank)

        def local(self, ranks):
            try:
                self.protector.check_budget(ranks)
            except RuntimeError as err:
                return err
            return None
        Pool._over_budget = local
    elif mutation == "unagreed_golden":
        _plant("late_flip", rank)
        workload.PoolWorkload.agreed = lambda self, flag: bool(flag)


def chaos_worker(group, plan, inputs_path, out_dir, kw):
    """A spawned worker: one plan on a zone split over `group`'s world,
    with a plant or a mutation on this process when `kw` names one; its
    records pickled to `out_dir/p<rank>.pkl` (tensors do not cross the
    spawn's pipes)."""
    torch.set_num_threads(1)
    kw = dict(kw)
    _plant(kw.pop("plant", None), group.rank)
    _mutate(kw.pop("mutation", None), group.rank)
    out = run(plan, group, torch.load(inputs_path), **kw)
    out["exchange"] = dict(group.stats)
    with open(os.path.join(out_dir, f"p{group.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return group.rank


def split(plan, inp, world, tmp_path, group_timeout=procs.GROUP_TIMEOUT_S,
          timeout=600.0, **kw) -> list:
    """The plan on `world` spawned workers: their records."""
    out_dir = tmp_path / f"{plan}-w{world}-{kw.get('mutation') or ''}" \
        f"{kw.get('plant') or ''}"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "inputs.pt"
    torch.save(inp, path)
    done = procs.spawn_zone(chaos_worker, world, plan, str(path),
                            str(out_dir), kw, timeout=timeout,
                            group_timeout=group_timeout)
    assert done == list(range(world))
    parts = []
    for rank in range(world):
        with open(out_dir / f"p{rank}.pkl", "rb") as f:
            parts.append(pickle.load(f))
    return parts


# -- comparing the workers with one process ----------------------------------------

def _same(want, got, what):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, f"{what}: {want.shape} vs {got.shape}"
    assert want.tobytes() == got.tobytes(), f"{what}: bytes differ"


def _field(want, got, lo, hi, name, what):
    """`got` is `want`'s data ranks [lo, hi) (data dim first), or the
    whole of a field every process holds whole (`WHOLE`)."""
    if want is None or got is None:
        assert want is None and got is None, what
    elif isinstance(want, dict):
        assert want.keys() == got.keys(), what
        for k in want:
            _field(want[k], got[k], lo, hi, name, f"{what}.{k}")
    elif name in WHOLE:
        if isinstance(want, (np.ndarray, np.generic)):
            _same(want, got, what)
        else:
            assert want == got, what
    else:
        _same(np.asarray(want)[lo:hi], got, what)


def check_block(want: dict, got: dict, what: str) -> bool:
    """A member's record holds its block of the one-process record's
    fields, byte for byte; returns False for a spare's (no fields)."""
    if got["pos"] is None:
        assert got["fields"] is None, what
        return False
    g = np.asarray(want["fields"]["row"]).shape[0]
    w = len(got["procs"])
    lo, hi = got["pos"] * g // w, (got["pos"] + 1) * g // w
    for name, v in want["fields"].items():
        _field(v, got["fields"][name], lo, hi, name, f"{name} ({what})")
    return True


def check_blocks(one: dict, parts: list, phases=None) -> None:
    """Every member's block of every phase's fields byte-equal to the
    one-process record's, and every data rank held by one member."""
    for phase in phases or one:
        want = one[phase]
        held = [check_block(want, part[phase], f"{phase} p{r}")
                for r, part in enumerate(parts)]
        procs_ = parts[0][phase]["procs"]
        assert sum(held) == len(procs_), (phase, held, procs_)
