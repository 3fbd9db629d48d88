"""The split-zone plans of tests/test_torch_procs_{window,ring}.py: the
deferred engine (window > 1, bulk and patch) and the async commit ring
(pipeline_depth > 1, staged canaries) on a zone split over processes.

A plan is a list of phases, each a name and a list of operations on one
`Pool`; the same plan drives the reference's Pool
(tests/_torch_procs_window_ref.py), the port's on one process and the
port's on each spawned worker (`plans_worker`, which imports no JAX: the
workers never do).  After every phase a record holds the pool's fields
(this process's block of ranks on a split zone), the open window's
(`acc`, `dirty`, `pending`, the patch engine's `live` row, the mirrored
window meta), the phase's report and the host figures.

Operations (`i` indexes the plan's global states, `kw` the commit's
keywords; word and page lists are python ints):

    ("commit", i, kw)       pool.commit, its verdict read
    ("async", i, kw)        pool.commit_async
    ("staged", i, kw)       commit_async with a staged canary that is
                            smashed on one process (False on one process)
    ("drain",)              pool.drain, the verdicts of every ticket
    ("poll",)               pool.poll, then pool.drain
    ("loss", ranks)         a rank loss (or an r-rank loss) injected into
                            the open window, then pool.recover
    ("scribble", rank, w)   word w of the rank's row flipped
    ("scrub",)              pool.scrub
    ("refuse", i, kw)       a patch commit past dirty_capacity: the port
                            refuses it on every process (the reference
                            has no such check and is not given it)

Each plan's inputs (a `torch.save`d dict) hold its configuration, its
global states and its fault plan.
"""
import pickle

import torch

from repro_torch import Fault, Pool, ProtectConfig, convert
from repro_torch.core import microbuffer
from repro_torch.dist.sharding import P, ZoneMesh
from repro_torch.kernels import ops
from repro_torch.runtime import failure
from tests._torch_procs_worker import report

STATS = ("engine", "window", "max_window", "commits", "aborted_commits",
         "scrub", "recoveries", "suspect", "budget_exhausted", "in_flight")


def stats(pool) -> dict:
    """The host figures two runs of one plan share (and the window's
    attempt count)."""
    st = pool.stats()
    out = {k: st[k] for k in STATS}
    out["since"] = pool.engine._since if pool.engine is not None else None
    return out


def fields(pool) -> dict:
    """convert's field dict of the protected state, plus the open
    window's fields and its mirrored meta (None on the sync engine)."""
    out = convert.from_port(pool.prot)
    est = pool._est
    if est is None:
        out.update(acc=None, dirty=None, pending=None, live=None, meta=None)
        return out
    win = convert.from_port_epoch(est)
    out.update(acc=win["acc"], dirty=win["dirty"], pending=win["pending"],
               live=convert._np_words(est.live),
               meta=pool.engine.window_meta)
    return out


def record(pool, rep) -> dict:
    return {"fields": fields(pool), "report": rep, "stats": stats(pool)}


def _words(kw):
    """A commit's keywords on the port: dirty_words as int64 tensors."""
    kw = dict(kw)
    if kw.get("dirty_words") is not None:
        kw["dirty_words"] = tuple(
            None if w is None else torch.tensor(w, dtype=torch.int64)
            for w in kw["dirty_words"])
    return kw


def run_plan(mesh, inp, smash: bool):
    """Yield (phase, pool, report) through the plan `inp["plan"]` on
    `mesh`; `smash`: whether this process's staged canary is smashed."""
    specs = {k: P(*v) for k, v in inp["specs"].items()}
    states = inp["states"]
    pool = Pool.open(states[0], specs, mesh=mesh, device="cpu",
                     config=ProtectConfig(**inp["config"]),
                     **inp.get("pool_kw", {}))
    tickets = []
    for phase, ops_ in inp["plan"]:
        rep = {}
        for op in ops_:
            kind = op[0]
            if kind == "commit":
                rep.setdefault("ok", []).append(
                    bool(pool.commit(states[op[1]], **_words(op[2]))))
            elif kind == "async":
                tickets.append(pool.commit_async(states[op[1]],
                                                 **_words(op[2])))
            elif kind == "staged":
                # a guard page checked on the device, smashed here only
                guards = ([microbuffer.check(failure.smashed_canary_buffer(
                    256, device="cpu"))] if smash else [])
                canary = ops.stage_verdict(guards, device="cpu")
                tickets.append(pool.commit_async(
                    states[op[1]], canary_ok=canary, **_words(op[2])))
            elif kind in ("drain", "poll"):
                if kind == "poll":
                    pool.poll()
                pool.drain()
                rep.setdefault("verdicts", []).extend(
                    t.result() for t in tickets)
                tickets = []
            elif kind == "loss":
                ranks = list(op[1])
                if len(ranks) == 1:
                    pool.inject(lambda p, prot: failure.inject_rank_loss(
                        p, prot, ranks[0]))
                    fault = Fault.rank_loss(ranks[0])
                else:
                    pool.inject(lambda p, prot: failure.inject_multi_rank_loss(
                        p, prot, ranks))
                    fault = Fault.multi_loss(*ranks)
                rep["recover"] = report(pool.recover(fault))
                rep["verdicts"] = [t.result() for t in tickets]
                tickets = []
            elif kind == "scribble":
                pool.inject(lambda p, prot: failure.inject_scribble(
                    p, prot, op[1], [op[2]]))
            elif kind == "scrub":
                rep.setdefault("scrub", []).append(report(pool.scrub()))
            elif kind == "refuse":
                try:
                    pool.commit(states[op[1]], **_words(op[2]))
                    rep["refused"] = None
                except ValueError as err:
                    rep["refused"] = str(err)
            else:
                raise ValueError(f"no operation {kind!r}")
        yield phase, pool, rep


def one_process(inp, **config) -> dict:
    """The plan on one process ({phase: record}); `config` overrides the
    plan's ProtectConfig (the depth-1 comparison)."""
    inp = dict(inp, config={**inp["config"], **config})
    shape, axes = inp["mesh"]
    return {phase: record(pool, rep) for phase, pool, rep in
            run_plan(ZoneMesh(shape, axes), inp, smash=True)}


def plans_worker(group, inputs_path, out_dir):
    """A spawned worker: every plan of `inputs_path` ({name: inputs}) on
    this process's block of a mesh split over `group`, the records pickled
    to `out_dir/p<rank>.pkl` ({name: {phase: record}}, with the gathered
    global state at each plan's end and what the exchanges moved)."""
    torch.set_num_threads(1)
    out = {}
    for name, inp in torch.load(inputs_path).items():
        shape, axes = inp["mesh"]
        mesh = ZoneMesh(shape, axes, group=group)
        recs = {}
        for phase, pool, rep in run_plan(mesh, inp, smash=group.rank ==
                                         group.world - 1):
            recs[phase] = record(pool, rep)
        recs["state"] = {k: convert._np_leaf(v)
                         for k, v in pool.state.items()}
        out[name] = recs
    out["exchange"] = dict(group.stats)
    with open(f"{out_dir}/p{group.rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    return group.rank


def meta_worker(group, x, dim, n_axes):
    """The window-meta collectives on this process's block of `x` (a
    zone-stacked int32 array of the whole zone, data dim `dim`)."""
    x = torch.from_numpy(x)
    from repro_torch.dist import collectives as coll
    torch.set_num_threads(1)
    g = x.shape[dim] // group.world
    mine = x.narrow(dim, group.rank * g, g).contiguous()
    mirror = coll.make_meta_mirror(dim, group)((mine, torch.tensor(7), None))
    # numpy, not tensors: a tensor would travel through a shared-memory
    # handle that the worker's exit closes
    return {"gather": coll.meta_all_gather(mine, dim, n_axes,
                                           group).numpy().copy(),
            "tree": coll.xor_tree_reduce(mine, dim, group).numpy().copy(),
            "mirror": mirror[0].numpy(), "step": int(mirror[1]),
            "mirror_none": mirror[2] is None}
