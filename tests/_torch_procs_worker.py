"""The split-zone phase sequence of tests/test_torch_procs*.py.

`run_phases` drives one port `Pool` through open, bulk commits with and
without verify_old, patch commits with and without it, a clean scrub and
pre-check, a rank loss, an r-rank loss (r >= 2), a scribble found by the
scrub and repaired, a flipped word found by the pre-check and repaired, a
smashed canary and an over-budget loss, and records after each phase the
pool's fields (`convert.from_port`: this process's block of ranks on a
split zone) and the phase's report.  The spawned workers run it on their
block (`zone_worker`, which imports no JAX: the workers never do), and
the tests run it on one process and hold both to the reference.

`inputs` (a `torch.save`d dict of CPU tensors and host values, made by
the test) holds the global states, the dirty pages and the fault plan.
"""
import contextlib
import dataclasses
import pickle
import time

import torch

from repro_torch import Fault, Pool, ProtectConfig, convert
from repro_torch.dist.sharding import P, ZoneMesh, split_mesh
from repro_torch.runtime import failure

TIMING = ("solve_ms", "reverify_ms", "total_ms", "queue_wait_ms")


def report(rep) -> dict:
    """A scrub or recovery report as a dict, its wall times left out."""
    d = dataclasses.asdict(rep)
    for k in TIMING:
        d.pop(k, None)
    return d


def stats(pool) -> dict:
    """The pool's host figures that two runs of one sequence share."""
    st = pool.stats()
    return {k: st[k] for k in ("mode", "redundancy", "engine", "commits",
                               "aborted_commits", "scrub", "recoveries",
                               "suspect", "budget_exhausted")}


def run_phases(mesh, inp, smash: bool):
    """Yield (phase, pool, report) through the sequence; `smash`: whether
    this process's canary is the smashed one."""
    specs = {k: P(*v) for k, v in inp["specs"].items()}
    r = inp["r"]
    states = inp["states"]
    pool = Pool.open(states[0], specs, mesh=mesh, device="cpu",
                     config=ProtectConfig(mode="mlpc", redundancy=r,
                                          block_words=inp["bw"]))
    yield "open", pool, {"overhead": pool.overhead_report()}

    with pool.transaction(data_cursor=1) as tx:
        tx.stage(states[1], verify_old=True)
    yield "bulk_verify", pool, {"ok": tx.ok}

    yield "bulk", pool, {"ok": bool(pool.commit(states[2], data_cursor=2))}

    dirty = inp["dirty"]
    with pool.transaction(data_cursor=3) as tx:
        tx.stage(states[3], dirty_pages=dirty, verify_old=True)
    yield "patch_verify", pool, {"ok": tx.ok}

    ok = pool.commit(states[4], dirty_pages=dirty, data_cursor=4)
    yield "patch", pool, {"ok": bool(ok)}

    yield "scrub", pool, report(pool.scrub())
    yield "precheck", pool, report(pool.precheck())

    pool.inject(lambda p, prot: failure.inject_rank_loss(
        p, prot, inp["lost"]))
    yield "rank_loss", pool, report(pool.recover(
        Fault.rank_loss(inp["lost"])))

    if r >= 2:
        pool.inject(lambda p, prot: failure.inject_multi_rank_loss(
            p, prot, inp["multi_lost"]))
        yield "multi_loss", pool, report(pool.recover(
            Fault.multi_loss(*inp["multi_lost"])))

    rank, word = inp["scribble"]
    pool.inject(lambda p, prot: failure.inject_scribble(p, prot, rank,
                                                        [word]))
    yield "scribble_scrub", pool, report(pool.scrub())

    rank, word = inp["flip"]
    pool.inject(lambda p, prot: failure.inject_scribble(p, prot, rank,
                                                        [word]))
    pre = report(pool.precheck())
    rec = report(pool.recover(Fault.scribble(rank, [word // inp["bw"]])))
    yield "flip_precheck", pool, {"precheck": pre, "recover": rec}

    zeros = {k: torch.zeros_like(v) for k, v in states[4].items()}
    with pool.transaction() as tx:
        if smash:
            tx.watch(failure.smashed_canary_buffer(256, device="cpu"))
        tx.stage(zeros)
    yield "canary", pool, {"aborted": tx.aborted, "ok": tx.ok}

    try:
        pool.recover(Fault.multi_loss(*inp["over_budget"]))
        refused = None
    except RuntimeError as err:
        refused = str(err)
    yield "over_budget", pool, {"refused": refused}


def record(pool, rep) -> dict:
    """One phase's record: the fields, the report and the stats."""
    return {"fields": convert.from_port(pool.prot), "report": rep,
            "stats": stats(pool)}


def zone_worker(group, inputs_path, out_dir):
    """A spawned worker: the sequence on this process's block of a mesh
    split over `group`, each phase's record pickled to `out_dir/p<rank>.pkl`
    (with the global state every process gathers at the end, and what its
    exchanges moved)."""
    torch.set_num_threads(1)
    inp = torch.load(inputs_path)
    shape, axes = inp["mesh"]
    mesh = ZoneMesh(shape, axes, group=group)
    out = {}
    for phase, pool, rep in run_phases(mesh, inp,
                                       smash=group.rank == group.world - 1):
        out[phase] = record(pool, rep)
    out["state"] = {k: convert._np_leaf(v) for k, v in pool.state.items()}
    out["exchange"] = dict(group.stats)
    with open(f"{out_dir}/p{group.rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    return group.rank


def failing_worker(group, kind):
    """`spawn_zone`'s failures: worker 1 raises ("raises"), worker 0 waits
    in a collective that worker 1 never joins ("hangs"), or both outlive
    the spawn's timeout ("sleeps"); the others sleep meanwhile."""
    if kind == "raises" and group.rank == 1:
        raise RuntimeError("planted failure")
    if kind == "hangs" and group.rank == 0:
        group.all_gather(torch.zeros(4))
    time.sleep(60)


def _refused(fn):
    try:
        fn()
    except (NotImplementedError, ValueError) as err:
        return type(err).__name__, str(err)
    return None


def refusal_worker(group):
    """What a zone split over `group` runs and refuses: {case: (error
    type, message), or None where nothing was raised}.  The deferred
    engine, the ring, a staged canary, PoolGroup, a rescale and a reshard
    onto a mesh split over the same group, a PoolGroup rescale that
    changes the process count, a Server whose batch G divides and a
    Trainer whose microbatches W divides run there; a rescale or a
    PoolGroup rescale onto a mesh with no common parent group (one
    process), a batch that G does not divide and microbatches that W does
    not divide are refused."""
    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.core.epoch import DeferredProtector
    from repro_torch.dist import elastic
    from repro_torch.runtime.server import Server
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.tenancy import PoolGroup

    torch.set_num_threads(1)
    axes = ("data", "model")
    mesh = ZoneMesh((4, 1), axes, group=group)
    state, specs = {"w": torch.zeros(8, 64)}, {"w": P("data")}

    def pool(**cfg):
        return Pool.open(state, specs, mesh=mesh, device="cpu",
                         config=ProtectConfig(block_words=64, **cfg))
    sync = pool()
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                      n_heads=4, n_kv=2, d_ff=64, vocab=128,
                      param_dtype="float32", compute_dtype="float32")
    same = ZoneMesh((2, 2), axes, group=mesh.group)

    def server(batch):
        return Server(cfg, ProtectConfig(), mesh, batch=batch, max_len=8,
                      device="cpu")

    def trainer(microbatches):
        return Trainer(cfg, TrainConfig(microbatches=microbatches),
                       ProtectConfig(), mesh, device="cpu")
    return {
        "window": _refused(lambda: pool(window=4)),
        "pipeline_depth": _refused(lambda: pool(pipeline_depth=2)),
        "staged_canary": _refused(lambda: sync.commit_async(
            state, canary_ok=torch.tensor(True))),
        "deferred": _refused(lambda: DeferredProtector(sync.protector,
                                                       window=4)),
        "pool_group": _refused(lambda: PoolGroup(mesh, device="cpu")),
        "rescale": _refused(lambda: sync.rescale(same)),
        "reshard": _refused(lambda: elastic.reshard_state(
            sync.prot.state, specs, mesh, same)),
        "server": _refused(lambda: server(4)),
        "trainer": _refused(lambda: trainer(2)),
        "rescale_regroup": _refused(lambda: sync.rescale(
            ZoneMesh((2, 2), axes))),
        "pool_group_regroup": _refused(lambda: PoolGroup(
            mesh, device="cpu").rescale(split_mesh((2, 2), axes, group,
                                                   (0,)))),
        "pool_group_one_process": _refused(lambda: PoolGroup(
            mesh, device="cpu").rescale(ZoneMesh((2, 2), axes))),
        "server_batch": _refused(lambda: server(2)),
        "trainer_microbatches": _refused(lambda: trainer(1)),
        "indivisible": _refused(lambda: ZoneMesh((3, 1), axes,
                                                 group=group)),
    }


class WireCounter:
    """A cost counter (kernels/cost.py) that keeps the wire reports only."""

    def __init__(self):
        self.wire_bytes = {}

    def kernel(self, name, nbytes, int_ops):
        return contextlib.nullcontext()

    def wire(self, kind, nbytes):
        self.wire_bytes[kind] = self.wire_bytes.get(kind, 0) + nbytes


def commit_wire(mesh) -> tuple:
    """The wire reports of one bulk commit on a (4, 1)-shaped `mesh`, and
    the bytes this process's group sent in it (0 on one process)."""
    from repro_torch.kernels import cost as kcost
    state = {"w": torch.arange(8 * 64, dtype=torch.float32).reshape(8, 64)}
    pool = Pool.open(state, {"w": P("data")}, mesh=mesh, device="cpu",
                     config=ProtectConfig(mode="mlpc", block_words=64))
    counter = WireCounter()
    sent = mesh.group.stats["sent_bytes"] if mesh.group is not None else 0
    kcost.push(counter)
    try:
        pool.commit({"w": state["w"] + 1})
    finally:
        kcost.pop(counter)
    if mesh.group is not None:
        sent = mesh.group.stats["sent_bytes"] - sent
    return counter.wire_bytes, sent


def wire_worker(group):
    torch.set_num_threads(1)
    return commit_wire(ZoneMesh((4, 1), ("data", "model"), group=group))
