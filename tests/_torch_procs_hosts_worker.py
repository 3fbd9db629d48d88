"""The split hosts' plans of tests/test_torch_procs_{group,server,trainer}.py:
`PoolGroup` with its rescale walk, `runtime.Server` and `runtime.Trainer`
on a zone split over processes.

Each plan yields (phase, record) pairs; the same plan runs on one
process in the pytest process and on each spawned worker (`hosts_worker`,
which imports no JAX: the workers never do).  A record holds every
pool's fields (this process's block of ranks on a split zone, with an
open window's), the phase's host values (verdicts, reports, tokens,
losses) and the pool's host figures.  `check_parts` holds every worker's
block byte-equal to the one-process record, phase by phase.

`MUTATIONS` are deliberate faults a worker can be told to make
(`mutation=`), each one that the comparison (or a failed collective)
must catch: a gradient fold
in another microbatch order, a process computing another block's rows,
tokens gathered out of rank order, a quarantine decided on a finding
this process alone sees, a rescale that keeps another process's block,
straggler drops decided on this process's own step times.
"""
import copy
import os
import pickle

import numpy as np
import torch

from repro_torch import Fault, ProtectConfig, ZoneMesh, convert, utils
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.dist import elastic, procs, sharding
from repro_torch.dist.sharding import P
from repro_torch.models import api
from repro_torch.runtime import failure
from repro_torch.runtime import server as server_mod
from repro_torch.runtime.server import Server
from repro_torch.runtime.trainer import Trainer
from repro_torch.tenancy import PoolGroup
from tests._torch_procs_window_worker import fields, stats
from tests._torch_procs_worker import report

MUTATIONS = ("fold_order", "other_rows", "tokens_reversed",
             "unagreed_quarantine", "wrong_offset", "unagreed_straggler")
# fields every process holds whole (not a block of ranks)
WHOLE = ("log", "step", "pending", "meta")


def record(pools: dict, extra=None) -> dict:
    """{"pools": {name: {"fields", "stats"}}, "extra": host values}."""
    return {"pools": {name: {"fields": fields(p), "stats": stats(p)}
                      for name, p in pools.items()},
            "extra": extra or {}}


# -- the PoolGroup plan ------------------------------------------------------------

SYNC = ("t0", "t1", "t2", "t3")
DEFERRED = ("d0", "d1")


def _tenant_pools(grp) -> dict:
    return {tid: grp[tid].pool for tid in grp.tenants}


def _held(mesh, rank: int) -> bool:
    return mesh.data_offset <= rank < mesh.data_offset + mesh.local_group_size


def group_plan(mesh, inp, mutation=None):
    """Four sync tenants and two window-2 tenants (mlpc, r = inp["r"]):
    admit, a wave with t2's canary failing, a verified wave (the deferred
    tenants' window flushes in it), a scribble on one process's rank
    found by `scrub_tick` and recovered under quarantine, a rank loss on
    t3 recovered beside an async wave of the others, an eviction, then
    the rescale walk to inp["walk"][0] and back, a wave after each."""
    specs = {k: P(*v) for k, v in inp["specs"].items()}
    states = inp["states"]
    grp = PoolGroup(mesh, device="cpu", full_scrub_every=1)
    for tid in SYNC + DEFERRED:
        cfg = ProtectConfig(mode="mlpc", redundancy=inp["r"],
                            block_words=inp["bw"],
                            window=2 if tid in DEFERRED else 1)
        grp.admit(tid, states[tid][0], specs, config=cfg)
    yield "admit", record(_tenant_pools(grp))

    def wave(i, **kw):
        oks = grp.commit({t: states[t][i] for t in grp.tenants},
                         data_cursor=i, **kw)
        return {t: bool(v) for t, v in oks.items()}
    yield "wave_t2_canary", record(_tenant_pools(grp), wave(
        1, canary_ok={t: t != "t2" for t in grp.tenants}))
    yield "verified_wave_flush", record(_tenant_pools(grp), wave(
        2, verify_old=True))

    rank, word = inp["scribble"]
    grp["t1"].pool.inject(lambda p, prot: failure.inject_scribble(
        p, prot, rank, [word]))
    served = grp.scrub_tick()
    found, recovered = [], []
    for tid, kind, rep in served:
        locs = [tuple(loc) for loc in rep.bad_locations]
        found.append((tid, kind, locs))
        if mutation == "unagreed_quarantine":
            # the finding as this process alone would see it
            locs = [loc for loc in locs if _held(mesh, loc[0])]
        if locs:
            rec = grp.recover(tid, Fault.scribble(
                locs[0][0], sorted({pg for _, pg in locs})))
            recovered.append((tid, report(rec)))
    yield "scrub_tick_quarantine", record(
        _tenant_pools(grp), {"found": found, "recovered": recovered})

    lost = inp["lost"]
    grp["t3"].pool.inject(lambda p, prot: failure.inject_rank_loss(
        p, prot, lost))
    ticket = grp.commit_async({t: states[t][3] for t in grp.tenants
                               if t != "t3"}, data_cursor=3)
    rec = grp.recover("t3", Fault.rank_loss(lost))
    grp.drain()
    yield "recover_t3_beside_a_wave", record(_tenant_pools(grp), {
        "recovered": report(rec), "wave": bool(ticket.result()),
        "quarantined": list(grp.quarantined)})

    out = grp.evict("t0")
    yield "evict_t0", record(_tenant_pools(grp), {
        "evicted": {k: convert._np_leaf(v) for k, v in out.items()}})

    if mutation == "wrong_offset":
        elastic.reshard_state = _reshard_wrong_offset
    axes = mesh.axis_names
    for j, shape in enumerate(inp["walk"]):
        grp = grp.rescale(ZoneMesh(shape, axes, group=mesh.group))
        yield f"rescale_{j}", record(_tenant_pools(grp))
        yield f"wave_after_rescale_{j}", record(
            _tenant_pools(grp), wave(4 + j))
    yield "state", {t: {k: convert._np_leaf(v) for k, v in
                        grp[t].pool.state.items()} for t in grp.tenants}


class _Shifted(ZoneMesh):
    """A split mesh whose process keeps the next process's block."""

    @property
    def data_offset(self) -> int:
        return ((self.proc_rank + 1) % self.world) * self.local_group_size


def _reshard_wrong_offset(state, specs, old_mesh, new_mesh, abstract=None,
                          device=None):
    """`elastic.reshard_state` keeping the next process's block."""
    shifted = copy.copy(new_mesh)
    shifted.__class__ = _Shifted
    leaves, treedef = utils.tree_flatten(state)
    return utils.tree_unflatten(treedef, [
        sharding.shard(sharding.unshard(x, sp, old_mesh), sp, shifted)
        for x, sp in zip(leaves, utils.tree_leaves(specs))])


# -- the Server plan ---------------------------------------------------------------

SERVER_CASES = {"sync": {},
                "window4": {"redundancy": 3, "window": 4},
                "depth2": {"pipeline_depth": 2}}


def server_plan(mesh, inp, cases=tuple(SERVER_CASES), mutation=None):
    """`serve` for each of `cases`, its phases named "case/phase"."""
    for case in cases:
        for phase, rec in serve(mesh, inp, case):
            yield f"{case}/{phase}", rec


def serve(mesh, inp, case):
    """A reduced model served at inp["batch"] on one of `SERVER_CASES`:
    start, a prompt of rows that differ and inp["n_new"] tokens with a
    rank loss recovered after step inp["event"] (on a rank off process
    0), then a scrub."""
    cfg = ModelConfig(**inp["cfg"])
    srv = Server(cfg, ProtectConfig(mode="mlpc", block_words=inp["bw"],
                                    scrub_period=inp["scrub"],
                                    **SERVER_CASES[case]),
                 mesh, batch=inp["batch"], max_len=inp["max_len"],
                 device="cpu")
    srv.start(inp["params"])
    yield "start", record({"cache": srv.pool})
    held = {}

    def hook(s, out):
        if out["pos"] == inp["event"]:
            s.pool.inject(lambda p, prot: failure.inject_rank_loss(
                p, prot, inp["lost"]))
            held["rank_loss"] = record({"cache": s.pool}, report(
                s.pool.recover(Fault.rank_loss(inp["lost"]))))
    srv.add_step_hook(hook)
    toks = srv.generate(inp["prompt"], inp["n_new"])
    yield "rank_loss", held["rank_loss"]
    yield "generate", record({"cache": srv.pool}, {"tokens": toks})
    yield "scrub", record({"cache": srv.pool}, report(srv.pool.scrub()))


def _rows_of_next_block(self, x):
    """`Server.block_rows` taking the next process's block."""
    g = self.mesh.group
    blocks = x.reshape(g.world, -1, *x.shape[1:])
    return blocks[(g.rank + 1) % g.world]


def _gather_reversed(x, spec, mesh):
    """`gather_global` stacking the processes' blocks in reverse order."""
    if mesh.group is None:
        return x
    return torch.cat(list(mesh.group.all_gather(x).flip(0)), dim=0)


# -- the Trainer plan --------------------------------------------------------------

def trainer_plan(mesh, inp, mutation=None, ckpt_in=None, ckpt_out=None):
    """A reduced model trained at inp["microbatches"]: init, two steps, a
    rank loss recovered, a scribble scrubbed, a step with a failed canary,
    a step, a checkpoint to `ckpt_out` and two steps more.  With
    `ckpt_in`, a fresh trainer then restores that checkpoint (written by
    the other kind of run) and replays the surviving log's steps.  With
    inp["straggler"] (a threshold), the pool runs the straggler policy and
    process 0 alone sees replica G - 1 run 8x slow (`replica_slowdown`):
    every process must drop it, as one process does."""
    cfg = ModelConfig(**inp["cfg"])
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=100,
                       microbatches=inp["microbatches"])

    def trainer(ckpt):
        return Trainer(cfg, tcfg, ProtectConfig(mode="mlpc",
                                                block_words=inp["bw"],
                                                scrub_period=inp["scrub"],
                                                straggler_threshold=inp.get(
                                                    "straggler", 0.0)),
                       mesh, seq_len=inp["seq"], global_batch=inp["batch"],
                       seed=inp["seed"], checkpoint_dir=ckpt, device="cpu")
    t = trainer(ckpt_out)
    if inp.get("straggler") and mesh.proc_rank == 0:
        t.replica_slowdown[-1] = 8.0
    t.initialize()
    yield "init", record({"train": t.pool})

    def steps(n, **kw):
        return [_out(t.step(**kw)) for _ in range(n)]
    yield "steps_1_2", record({"train": t.pool}, {"outs": steps(2)})
    lost = inp["lost"]
    t.pool.inject(lambda p, prot: failure.inject_rank_loss(p, prot, lost))
    yield "rank_loss", record({"train": t.pool}, report(
        t.pool.recover(Fault.rank_loss(lost))))
    rank, word = inp["scribble"]
    t.pool.inject(lambda p, prot: failure.inject_scribble(p, prot, rank,
                                                          [word]))
    yield "scribble_scrub", record({"train": t.pool},
                                   report(t.pool.scrub()))
    yield "canary_fails", record({"train": t.pool}, {
        "outs": steps(1, canary_ok=False), "cursor": t.cursor})
    yield "step_3", record({"train": t.pool}, {"outs": steps(1)})
    if ckpt_out is not None:
        t.save_checkpoint(wait=True)
    yield "steps_4_5", record({"train": t.pool}, {"outs": steps(2)})
    log = t.prot.log
    if ckpt_in is not None:
        del t
        fresh = trainer(ckpt_in)
        info = fresh.restore_from_checkpoint(log=log)
        yield "restored_replayed", record({"train": fresh.pool}, {
            "info": info, "outs": [_out(o) for o in fresh.history]})


def _out(o: dict) -> dict:
    return {k: o[k] for k in ("step", "loss", "committed",
                              "dropped_replicas") if k in o}


def _fold_reversed(parts, nmb):
    acc = torch.zeros(parts[0].shape, dtype=torch.float32,
                      device=parts[0].device)
    for i in reversed(range(nmb)):
        acc = acc + parts[i]
    return acc / nmb


def _other_microbatches(nmb, world, rank):
    k = nmb // world
    other = (rank + 1) % world
    return range(other * k, (other + 1) * k)


# -- running a plan ----------------------------------------------------------------

PLANS = {"group": group_plan, "server": server_plan, "trainer": trainer_plan}


def _mutate(mutation) -> None:
    """Plant `mutation` in this process (a spawned worker only)."""
    if mutation == "fold_order":
        api.fold = _fold_reversed
    elif mutation == "other_rows":
        api.own_microbatches = _other_microbatches
        Server.block_rows = _rows_of_next_block
    elif mutation == "tokens_reversed":
        server_mod.sharding.gather_global = _gather_reversed
    elif mutation == "unagreed_straggler":
        Trainer.agreed_times = lambda self, times: times


def run(plan, mesh, inp, **kw) -> dict:
    """{phase: record} of one plan on `mesh`."""
    return dict(PLANS[plan](mesh, inp, **kw))


def hosts_worker(group, plan, inputs_path, out_dir, kw):
    """A spawned worker: the plan on this process's block of a mesh split
    over `group`, its records pickled to `out_dir/p<rank>.pkl`."""
    torch.set_num_threads(1)
    kw = dict(kw)
    _mutate(kw.get("mutation"))
    inp = torch.load(inputs_path)
    # a smaller piece runs the large exchanges' chunked branch
    procs.CHUNK_BYTES = inp.get("chunk_bytes", procs.CHUNK_BYTES)
    shape, axes = inp["mesh"]
    mesh = ZoneMesh(shape, axes, group=group)
    out = run(plan, mesh, inp, **kw)
    out["exchange"] = dict(group.stats)
    with open(os.path.join(out_dir, f"p{group.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return group.rank


def split(plan, inp, world, tmp_path, group_timeout=procs.GROUP_TIMEOUT_S,
          **kw) -> list:
    """The plan on `world` spawned workers: their records."""
    out_dir = tmp_path / f"{plan}-w{world}"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "inputs.pt"
    torch.save(inp, path)
    done = procs.spawn_zone(hosts_worker, world, plan, str(path),
                            str(out_dir), kw, timeout=600,
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


def _host(want, got, what):
    """Host values: equal, arrays byte-equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and want.keys() == got.keys(), what
        for k in want:
            _host(want[k], got[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), what
        for i, (a, b) in enumerate(zip(want, got)):
            _host(a, b, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        _same(want, got, what)
    else:
        assert want == got, (what, want, got)


def check_parts(one: dict, parts: list, sizes: dict) -> None:
    """Every worker's block of every pool field byte-equal to the
    one-process run's, phase by phase, and its host values and figures
    equal.  `sizes` {phase: G} gives the zone's data ranks (a rescale
    changes it; phases not named use sizes[None])."""
    for rank, part in enumerate(parts):
        assert [p for p in part if p != "exchange"] == list(one)
        for phase, want in one.items():
            g = sizes.get(phase, sizes[None])
            gl = g // len(parts)
            lo, hi = rank * gl, (rank + 1) * gl
            got = part[phase]
            what = f"{phase} p{rank}"
            if phase == "state":
                _host(want, got, what)
                continue
            assert want["pools"].keys() == got["pools"].keys(), what
            for name, w in want["pools"].items():
                for field, v in w["fields"].items():
                    _field(v, got["pools"][name]["fields"][field], lo, hi,
                           field, f"{field} ({what} {name})")
                assert got["pools"][name]["stats"] == w["stats"], (
                    what, name)
            _host(want["extra"], got["extra"], f"{what} extra")
        assert part["exchange"]["sent_bytes"] > 0
