"""The plans of tests/test_torch_procs_regroup.py: a `PoolGroup` rescaled
across process counts, a chaos snapshot restored onto another mesh, a
run that ends on other processes than it began on, and a same-group
rescale that moves no row of a data-sharded leaf, on a zone split over
processes.

Each plan yields (phase, record) pairs; the same plan runs on one process
in the pytest process (no group: every mesh unsplit) and on each spawned
worker (`regroup_worker`, which imports no JAX: the workers never do).
Records hold this process's place on the phase's mesh and its pools'
fields (tests/_torch_procs_chaos_worker.py's `record`), and a group's
tenants, cohorts, weights and configs.

`MUTATIONS` are deliberate faults a worker can be told to make
(`mutation=`), each one that a comparison (or an exchange left waiting)
must catch: newcomers admitting the tenants in another order, a tenant's
config and weight not sent to the newcomers, a snapshot block restored
at the current mesh's offset without the move, the golden block compared
at the first mesh's offset, a spare that skips the restore's exchange.
"""
import os
import pickle

import torch

from repro_torch import Pool, ProtectConfig
from repro_torch.chaos import runner, scenarios, workload
from repro_torch.chaos.runner import ScenarioRunner
from repro_torch.chaos.schedule import ChaosEvent, FaultSchedule
from repro_torch.chaos.workload import PoolWorkload, mesh_over
from repro_torch.dist import procs, sharding
from repro_torch.dist.sharding import P
from repro_torch.obs import Tracer, validate_events
from repro_torch.tenancy import PoolGroup
from repro_torch.tenancy import group as group_mod
from repro_torch.tenancy.qos import QoSClass
from tests._torch_procs_chaos_worker import place, record

E = ChaosEvent.make
MUTATIONS = ("admit_order", "table_unsent", "restore_unmoved",
             "golden_unmoved", "spare_skips_restore")
# the group walk's cases: (redundancy, window); a "grow" case walks
# inp["walks"]["grow"], the others inp["walks"][None]
GROUP_CASES = {"r1_sync": (1, 1), "r3_sync": (3, 1), "r1_w2": (1, 2),
               "r3_w2": (3, 2), "grow_r1_w2": (1, 2), "grow_r3_sync": (3, 1)}
# tenant: (its states' key in inp["states"], weight, QoS name, block words)
TENANTS = {"t0": ("a", 1, None, 64), "t1": ("a", 3, "silver", 64),
           "t2": ("b", 2, None, 64), "t3": ("a", 1, "gold", 32)}
SCRUB_BUDGET = 6


def _moved(group) -> int:
    return 0 if group is None else group.root.stats["moved_bytes"]


def _specs(inp) -> dict:
    return {k: {n: P(*v) for n, v in s.items()}
            for k, s in inp["specs"].items()}


# -- a PoolGroup across process counts ----------------------------------------

def group_record(grp, mesh, **extra) -> dict:
    """This process's place, and its group's tenants, cohorts, weights,
    configs and each tenant's fields (None on a spare)."""
    out = place(mesh)
    if grp is None:
        out["group"] = None
    else:
        out["group"] = {
            "tenants": grp.tenants,
            "cohorts": grp.stats()["cohorts"],
            "weights": {t: grp[t].weight for t in grp.tenants},
            "configs": {t: grp[t].pool.config for t in grp.tenants},
            "qos": {t: None if grp[t].qos is None else grp[t].qos.name
                    for t in grp.tenants},
            "settings": grp._table()["settings"],
            "tenant": {t: record(grp[t].pool, mesh)
                       for t in grp.tenants}}
    out.update(extra)
    return out


def group_plan(group, inp, cases=tuple(GROUP_CASES)):
    """For each case: four tenants (two cohorts of the case's config and
    one at other block words; weights and QoS classes set) admitted on
    the walk's first (shape, processes), then for each later one a wave
    and a rescale there, with the bytes this process moved; a wave and a
    scrub tick after the walk.  A spare of a mesh holds no group: it takes
    part in the rescales only (`PoolGroup.join`)."""
    specs = _specs(inp)
    for case in cases:
        r, window = GROUP_CASES[case]
        walk = inp["walks"]["grow" if case.startswith("grow") else None]
        mesh = mesh_over(walk[0][0], group, walk[0][1])
        grp = None
        if not mesh.is_spare:
            grp = PoolGroup(mesh, device="cpu", capacity=8,
                            scrub_page_budget=SCRUB_BUDGET,
                            full_scrub_every=2)
            for tid, (key, weight, qos, bw) in TENANTS.items():
                cfg = ProtectConfig(mode="mlpc", redundancy=r,
                                    window=window, block_words=bw)
                grp.admit(tid, inp["states"][0][tid], specs[key],
                          config=cfg, weight=weight,
                          qos=None if qos is None else QoSClass(qos, cfg))
        yield f"{case}/open", group_record(grp, mesh)
        for i, (shape, k) in enumerate((*walk[1:], (None, None)), start=1):
            if grp is not None:
                ups = {tid: {n: sharding.block_of(x, specs[TENANTS[tid][0]][n],
                                                  mesh)
                             for n, x in inp["states"][i][tid].items()}
                       for tid in TENANTS}
                oks = grp.commit(ups, data_cursor=i, block=True)
                assert all(bool(v) for v in oks.values()), oks
            yield f"{case}/wave_{i}", group_record(grp, mesh)
            if shape is None:
                break
            new = mesh_over(shape, group, k)
            moved = _moved(group)
            if grp is not None:
                grp = grp.rescale(new)
            else:
                grp = PoolGroup.join(mesh, new, device="cpu")
            mesh = new
            yield f"{case}/rescale_{i}", group_record(
                grp, mesh, moved=_moved(group) - moved)
        found = None
        if grp is not None:
            found = [(tid, kind, sorted(tuple(int(v) for v in loc)
                                        for loc in rep.bad_locations))
                     for tid, kind, rep in grp.scrub_tick(page_budget=0)]
        yield f"{case}/scrub", group_record(grp, mesh, found=found)


# -- the chaos runs that cross meshes -----------------------------------------

def restore_schedule(meshes, over, seed) -> FaultSchedule:
    """A snapshot on the first mesh, a rescale to the second, a two-rank
    loss there (past r = 1: the restore and replay, from the snapshot's
    mesh onto this one), a rescale back, a single loss recovered online;
    the losses pinned to ranks that lie on processes other than 0."""
    return FaultSchedule([
        E(2, "snapshot"),
        E(4, "rescale", shape=tuple(meshes[1]), **over[1]),
        E(8, "multi_loss", ranks=(2, 7)),
        E(12, "rescale", shape=tuple(meshes[0]), **over[0]),
        E(16, "rank_loss", rank=13),
    ], seed=seed)


def chaos_jobs(group, inp) -> dict:
    """{name: a builder of (workload, schedule, steps)}:
    budget_exhaust_rearm's workload on `restore_schedule`, and
    rescale_under_traffic with its first rescale only (it ends on the
    second mesh's processes)."""
    size = dict(meshes=inp["meshes"], n_bytes=inp["n_bytes"], device="cpu",
                group=group)
    over = [{}, {}]
    if group is not None:
        over = [{"procs": workload.fit_procs(int(m[0]), group.root.world)}
                for m in inp["meshes"]]

    def restore():
        wl, _, n = scenarios.budget_exhaust_rearm(True, inp["seed"], **size)
        return wl, restore_schedule(inp["meshes"], over, inp["seed"]), n

    def ends():
        wl, sched, n = scenarios.rescale_under_traffic(True, inp["seed"],
                                                       **size)
        return wl, FaultSchedule(list(sched)[:2], seed=inp["seed"]), n
    return {"restore_across_rescale": restore, "ends_elsewhere": ends}


def chaos_plan(group, inp, names=("restore_across_rescale",
                                  "ends_elsewhere")):
    """Each run: its golden verdict, trace violations, recoveries (kind,
    step, verified), moved bytes, the steps this process sat out, and its
    final pool."""
    for name in names:
        wl, sched, n = chaos_jobs(group, inp)[name]()
        tracer = Tracer()
        wl.set_tracer(tracer)
        out = ScenarioRunner(wl, sched).run(n)
        yield name, {
            "golden_exact": out["golden_exact"],
            "violations": validate_events(tracer.events),
            "recoveries": [
                {k: rec.get(k) for k in ("step", "kind", "verified")}
                for rec in out["recoveries"]],
            "moved": [(rec["kind"], rec["moved_bytes"])
                      for rec in out["recoveries"] if "moved_bytes" in rec],
            "spare_steps": out.get("spare_steps", []),
            "final": record(wl.pool, wl.mesh)}


# -- a same-group rescale -----------------------------------------------------

def same_group_plan(group, inp):
    """A pool (mlpc; r = 1 sync, r = 3 at window 2) walked (8, 1) -> (4, 2)
    -> (8, 1) over the same processes, a commit before each rescale, with
    `sharding.gather_global` and a split `sharding.unshard` made to raise:
    no process gathers the global state."""
    specs = _specs(inp)["a"]
    real = sharding.unshard

    def unshard(y, spec, mesh, **kw):
        if mesh.group is not None:
            raise AssertionError("a same-group rescale gathered a leaf")
        return real(y, spec, mesh, **kw)

    def gather_global(*a, **kw):
        raise AssertionError("a same-group rescale called gather_global")
    saved = sharding.unshard, sharding.gather_global
    for r, window in ((1, 1), (3, 2)):
        case = f"r{r}_w{window}"
        cfg = ProtectConfig(mode="mlpc", redundancy=r, window=window,
                            block_words=64)
        mesh = mesh_over((8, 1), group)
        pool = Pool.open(inp["states"][0]["t0"], specs, mesh=mesh,
                         config=cfg, device="cpu")
        yield f"{case}/open", record(pool, mesh)
        for i, shape in enumerate(((4, 2), (8, 1)), start=1):
            block = {n: sharding.block_of(x, specs[n], mesh)
                     for n, x in inp["states"][i]["t0"].items()}
            assert bool(pool.commit(block, data_cursor=i, block=True))
            new = mesh_over(shape, group)
            moved = _moved(group)
            sharding.unshard, sharding.gather_global = unshard, gather_global
            try:
                pool = pool.rescale(new)
            finally:
                sharding.unshard, sharding.gather_global = saved
            mesh = new
            yield f"{case}/rescale_{i}", record(
                pool, mesh, moved=_moved(group) - moved)


PLANS = {"group": group_plan, "chaos": chaos_plan,
         "same_group": same_group_plan}


def run(plan, group, inp, **kw) -> dict:
    """{phase: record} of one plan (one process: `group` None)."""
    return dict(PLANS[plan](group, inp, **kw))


# -- mutations ----------------------------------------------------------------

def _mutate(mutation) -> None:
    """Plant `mutation` in this process (a spawned worker only)."""
    if mutation in ("admit_order", "table_unsent"):
        real = group_mod._regroup

        def regroup(table, old_mesh, new_mesh, pools, **kw):
            if pools is None:                 # a newcomer
                rows = table["tenants"]
                if mutation == "admit_order":
                    rows = rows[::-1]
                else:
                    rows = [(t, a, s, None, q, None)
                            for t, a, s, _c, q, _w in rows]
                table = dict(table, tenants=rows)
            return real(table, old_mesh, new_mesh, pools, **kw)
        group_mod._regroup = regroup
    elif mutation == "restore_unmoved":
        def restore(self, snap):
            self.t = int(snap["t"])
            if self.pool is not None:
                self.pool.init(snap["state"], block=True)
        PoolWorkload.restore = restore
    elif mutation == "golden_unmoved":
        def golden(self, n_steps):
            ref = PoolWorkload(self._mesh0, self.config,
                               n_bytes=self.n_words * 4, seed=self.seed,
                               device=self.device)
            for _ in range(n_steps):
                ref.traffic_step()
            return ref.final_host()
        PoolWorkload.golden = golden
    elif mutation == "spare_skips_restore":
        real = runner.ScenarioRunner._restore

        def restore(self, snap, t, err, t0=None):
            if self.wl.pool is None:
                self.wl.t = t + 1
                return {"step": t, "kind": "restore_replay"}
            return real(self, snap, t, err, t0)
        runner.ScenarioRunner._restore = restore


def regroup_worker(group, plan, inputs_path, out_dir, kw):
    """A spawned worker: one plan on a zone split over `group`'s world,
    with a mutation on this process when `kw` names one; its records
    pickled to `out_dir/p<rank>.pkl` (tensors do not cross the spawn's
    pipes)."""
    torch.set_num_threads(1)
    kw = dict(kw)
    _mutate(kw.pop("mutation", None))
    out = run(plan, group, torch.load(inputs_path), **kw)
    with open(os.path.join(out_dir, f"p{group.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return group.rank


def split(plan, inp, world, tmp_path, group_timeout=procs.GROUP_TIMEOUT_S,
          timeout=600.0, **kw) -> list:
    """The plan on `world` spawned workers: their records."""
    out_dir = tmp_path / f"{plan}-w{world}-{kw.get('mutation') or ''}"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "inputs.pt"
    torch.save(inp, path)
    done = procs.spawn_zone(regroup_worker, world, plan, str(path),
                            str(out_dir), kw, timeout=timeout,
                            group_timeout=group_timeout)
    assert done == list(range(world))
    parts = []
    for rank in range(world):
        with open(out_dir / f"p{rank}.pkl", "rb") as f:
            parts.append(pickle.load(f))
    return parts
