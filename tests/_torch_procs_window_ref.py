"""The reference side of tests/test_torch_procs_{window,ring}.py.

`plans(mesh_name, names)` makes the plans' inputs from a seed (the
operations are tests/_torch_procs_window_worker.py's): global states of
tests/_torch_procs_ref.py's three kinds of leaf, patches whose deltas
differ by rank (an equal delta on every rank would cancel in an even
zone's XOR parity), and each plan's faults.  `ref_plan` drives the
reference's Pool through a plan; `run_case` runs the plans through the
reference and the one-process port once per mesh, spawns the port's
workers and holds every worker's slice of every field — the protected
state, the open window's `acc`, `dirty`, `pending` and `live`, the
mirrored window meta — byte-equal to both after every phase, its reports
and host figures to theirs.
"""
import pickle

import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import ProtectConfig as RefConfig
from repro.kernels import ops as ref_ops
from repro.pool import Fault as RefFault
from repro.pool import Pool as RefPool
from repro.runtime import failure as ref_failure
from repro_torch import convert
from repro_torch.core import layout
from repro_torch.dist import procs, sharding
from repro_torch.dist.sharding import ZoneMesh
from tests import _torch_procs_window_worker as worker
from tests._torch_procs_ref import (BW, DIRTY, MASK, SPECS, _patched, _same,
                                    _state)
from tests._torch_ref import (MESHES, jax_mesh, jax_specs, port_specs,
                              ref_fields, to_jax, to_torch)

STREAMED = {"stream_threshold_words": 1, "stream_chunk_words": 128}
PATCH_LEAF = 1          # w_fsdp: data-split, so its words differ by rank
# host figures the reference's Pool keeps too
REF_STATS = ("window", "max_window", "commits", "aborted_commits", "scrub",
             "recoveries", "suspect", "in_flight", "since")


def _layout(mesh_name):
    shape, axes = MESHES[mesh_name]
    zm, ps = ZoneMesh(shape, axes), port_specs(SPECS)
    return zm, ps


def _flip_words(state_np, mesh_name, words, salt):
    """`state_np` with the given words of every rank's w_fsdp shard (leaf
    word indices; those past the leaf skipped) flipped by a mask that
    differs by rank and by `salt`."""
    zm, ps = _layout(mesh_name)
    g = zm.shape[0]
    st = to_torch(state_np)
    lo = layout.build_layout(st, g, ps, zm, block_words=BW)
    slot = lo.slots[PATCH_LEAF]
    row = layout.flatten_row(lo, {k: sharding.shard(v, ps[k], zm)
                                  for k, v in st.items()})
    at = [slot.offset + w for w in words if w < slot.n_words]
    mask = torch.zeros_like(row)
    for i in range(g):
        mask[i, :, at] = MASK * (i + 1 + 8 * salt)
    new = layout.unflatten_row(lo, row ^ mask)
    out = {k: convert._np_leaf(sharding.unshard(v, ps[k], zm))
           for k, v in new.items()}
    out["w_tp"] = out["w_tp"].view(jnp.bfloat16)
    out["scale"] = out["scale"].reshape(())
    return out


def _leaf_words(mesh_name):
    zm, ps = _layout(mesh_name)
    st = to_torch(_state(np.random.default_rng(0)))
    return layout.build_layout(st, zm.shape[0], ps, zm,
                               block_words=BW).slots[PATCH_LEAF].n_words


def _dc(i, **kw):
    return dict(data_cursor=i, **kw)


def bulk(mesh_name, r):
    """The bulk engine at window 4 (r = 1 flat, r = 3 streamed): in-window
    commits, a staged abort smashed on one process, the boundary flush, a
    mid-window loss of r ranks with its window bound, a clean scrub, a
    scribble whose scrub collapses the window to 1, two commits there,
    and a clean scrub that regrows it."""
    g = MESHES[mesh_name][0][0]
    rng = np.random.default_rng(10 + r)
    states = [_state(rng) for _ in range(11)]
    lost = [0, g // 2, g - 1] if r >= 2 else [g - 1]
    plan = [
        ("open", []),
        ("commit_1", [("commit", 1, _dc(1))]),
        ("commit_2", [("commit", 2, _dc(2))]),
        ("staged_abort", [("staged", 3, _dc(3)), ("drain",)]),
        ("boundary_flush", [("commit", 3, _dc(4))]),
        ("commit_5_6", [("commit", 4, _dc(5)), ("commit", 5, _dc(6))]),
        ("mid_window_loss", [("loss", lost)]),
        ("scrub", [("scrub",)]),
        ("scribble_collapse", [("commit", 6, _dc(7)),
                               ("scribble", g // 2, 70), ("scrub",)]),
        ("window_1", [("commit", 7, _dc(8)), ("commit", 8, _dc(9))]),
        ("regrow", [("scrub",), ("commit", 9, _dc(10)),
                    ("commit", 10, _dc(11))]),
    ]
    config = dict(mode="mlpc", redundancy=r, block_words=BW, window=4,
                  **(STREAMED if r >= 2 else {}))
    return {"np_states": states, "plan": plan, "config": config}


def patch(mesh_name, r=3):
    """The patch engine, mode mlp, window 4, on w_fsdp with two pages a
    commit (its flush the xor_delta patch), the meta mirrored: commits
    naming their words (one set past the leaf), a staged abort smashed on
    one process, a footprint past the capacity refused on every process,
    the boundary flush, a scrub, a rank loss and a commit at window 1."""
    g = MESHES[mesh_name][0][0]
    n = _leaf_words(mesh_name)
    rng = np.random.default_rng(20 + r)
    s0 = _state(rng)
    a = list(range(10, 40))
    b = list(range(300, 311)) + [n, n + 5000]
    c = list(range(500, 520))
    d = list(range(700, 712))
    e = list(range(1000, 1010))
    far = [0, 300, 700, 1000]                    # four pages
    p1 = _flip_words(s0, mesh_name, a, 1)
    p2 = _flip_words(p1, mesh_name, b, 2)
    p3 = _flip_words(p2, mesh_name, c, 3)
    refused = _flip_words(p2, mesh_name, far, 1)
    p4 = _flip_words(p2, mesh_name, d, 2)
    p5 = _flip_words(p4, mesh_name, e, 3)

    def words(w):
        return {"dirty_words": (w,)}
    plan = [
        ("open", []),
        ("patch_1", [("commit", 1, _dc(1, **words(a)))]),
        ("patch_2_past_leaf", [("commit", 2, _dc(2, **words(b)))]),
        ("staged_abort", [("staged", 3, _dc(3, **words(c))), ("drain",)]),
        ("refused", [("refuse", 4, _dc(4, **words(far)))]),
        ("boundary_flush", [("commit", 5, _dc(4, **words(d)))]),
        ("scrub", [("scrub",)]),
        ("rank_loss", [("loss", [g - 1])]),
        ("window_1", [("commit", 6, _dc(5, **words(e)))]),
    ]
    config = dict(mode="mlp", redundancy=r, block_words=BW, window=4)
    pool_kw = dict(dirty_leaf_idx=[PATCH_LEAF], dirty_capacity=1,
                   replicate_meta=True)
    return {"np_states": [s0, p1, p2, p3, refused, p4, p5], "plan": plan,
            "config": config, "pool_kw": pool_kw}


def ring_sync(mesh_name, r=3):
    """The ring at depth 4 on the synchronous engine: a verified bulk, a
    bulk, a staged abort smashed on one process, a patch whose pages have
    an owner on every rank, a bulk (the fifth resolves the first), poll
    and drain; three tickets in flight through an r-rank loss; a scrub."""
    g = MESHES[mesh_name][0][0]
    rng = np.random.default_rng(30 + r)
    s = [_state(rng) for _ in range(3)]
    s.append(_patched(s[2], mesh_name, DIRTY[mesh_name]))
    s += [_state(rng) for _ in range(4)]
    plan = [
        ("open", []),
        ("dispatch_poll_drain", [
            ("async", 1, _dc(1, verify_old=True)), ("async", 2, _dc(2)),
            ("staged", 1, _dc(3)),
            ("async", 3, _dc(4, dirty_pages=DIRTY[mesh_name])),
            ("async", 4, _dc(5)), ("poll",)]),
        ("loss_in_flight", [("async", 5, _dc(6)), ("async", 6, _dc(7)),
                            ("async", 7, _dc(8)),
                            ("loss", [0, g // 2, g - 1][:r])]),
        ("scrub", [("scrub",)]),
    ]
    config = dict(mode="mlpc", redundancy=r, block_words=BW,
                  pipeline_depth=4)
    return {"np_states": s, "plan": plan, "config": config}


def ring_window(mesh_name, r=1):
    """The ring at depth 3 on the bulk engine at window 4: a window with a
    staged abort smashed on one process, drained at its boundary; a clean
    window, polled and drained; two tickets in flight through a
    mid-window rank loss; a scrub."""
    g = MESHES[mesh_name][0][0]
    rng = np.random.default_rng(40 + r)
    s = [_state(rng) for _ in range(10)]
    plan = [
        ("open", []),
        ("window_1", [("async", 1, _dc(1)), ("async", 2, _dc(2)),
                      ("staged", 3, _dc(3)), ("async", 3, _dc(4)),
                      ("drain",)]),
        ("window_2", [("async", i, _dc(i + 1)) for i in range(4, 8)]
         + [("poll",)]),
        ("loss_in_flight", [("async", 8, _dc(9)), ("async", 9, _dc(10)),
                            ("loss", [g - 1])]),
        ("scrub", [("scrub",)]),
    ]
    config = dict(mode="mlpc", redundancy=r, block_words=BW, window=4,
                  pipeline_depth=3)
    return {"np_states": s, "plan": plan, "config": config}


PLANS = {"bulk_r1": lambda m: bulk(m, 1), "bulk_r3": lambda m: bulk(m, 3),
         "patch_r3": patch, "ring_sync_r3": ring_sync,
         "ring_window_r1": ring_window}


def plans(mesh_name, names) -> dict:
    """{name: inputs}: `np_states` for the reference, the rest (torch
    states included) for `run_plan`."""
    out = {}
    for name in names:
        inp = PLANS[name](mesh_name)
        inp.update(states=[to_torch(s) for s in inp["np_states"]],
                   mesh=MESHES[mesh_name], specs=SPECS)
        out[name] = inp
    return out


def _ref_kw(kw):
    kw = dict(kw)
    if kw.get("dirty_words") is not None:
        kw["dirty_words"] = tuple(np.asarray(w, np.int32)
                                  for w in kw["dirty_words"])
    return kw


def _ref_record(pool, rep, mesh) -> dict:
    out = ref_fields(pool.prot, mesh)
    est, eng = pool._est, pool.engine
    arr = (lambda x: None if x is None else np.asarray(x))
    out.update(acc=arr(est.acc) if est is not None else None,
               dirty=arr(est.dirty) if est is not None else None,
               pending=arr(est.pending) if est is not None else None,
               meta=eng.window_meta if eng is not None else None)
    st = pool.stats()
    stats = {k: st[k] for k in REF_STATS if k != "since"}
    stats["since"] = eng._since if eng is not None else None
    return {"fields": out, "report": rep, "stats": stats}


def ref_plan(mesh_name, inp) -> dict:
    """The plan through the reference's Pool (no donation: the ring's
    verdicts outlive their commit): {phase: record}, and the final global
    state under "state"."""
    mesh = jax_mesh(mesh_name)
    st = [to_jax(s, SPECS, mesh) for s in inp["np_states"]]
    pool = RefPool.open(st[0], jax_specs(SPECS), mesh=mesh,
                        config=RefConfig(**inp["config"]), donate=False,
                        **inp.get("pool_kw", {}))
    out, tickets = {}, []
    for phase, ops_ in inp["plan"]:
        rep = {}
        for op in ops_:
            kind = op[0]
            if kind == "commit":
                rep.setdefault("ok", []).append(
                    bool(pool.commit(st[op[1]], **_ref_kw(op[2]))))
            elif kind == "async":
                tickets.append(pool.commit_async(st[op[1]],
                                                 **_ref_kw(op[2])))
            elif kind == "staged":
                canary = ref_ops.stage_verdict([jnp.asarray(False)])
                tickets.append(pool.commit_async(st[op[1]], canary_ok=canary,
                                                 **_ref_kw(op[2])))
            elif kind in ("drain", "poll"):
                if kind == "poll":
                    pool.poll()
                pool.drain()
                rep.setdefault("verdicts", []).extend(
                    bool(t.result()) for t in tickets)
                tickets = []
            elif kind == "loss":
                ranks = list(op[1])
                if len(ranks) == 1:
                    pool.inject(lambda p, prot: ref_failure.inject_rank_loss(
                        p, prot, ranks[0]))
                    fault = RefFault.rank_loss(ranks[0])
                else:
                    pool.inject(lambda p, prot:
                                ref_failure.inject_multi_rank_loss(
                                    p, prot, ranks))
                    fault = RefFault.multi_loss(*ranks)
                rep["recover"] = worker.report(pool.recover(fault))
                rep["verdicts"] = [bool(t.result()) for t in tickets]
                tickets = []
            elif kind == "scribble":
                pool.inject(lambda p, prot: ref_failure.inject_scribble(
                    p, prot, op[1], [op[2]]))
            elif kind == "scrub":
                rep.setdefault("scrub", []).append(
                    worker.report(pool.scrub()))
            elif kind == "refuse":
                pass              # the reference has no footprint check
            else:
                raise ValueError(f"no operation {kind!r}")
        out[phase] = _ref_record(pool, rep, mesh)
    out["state"] = {k: np.asarray(v) for k, v in pool.state.items()}
    return out


def split(inputs, world, tmp_path) -> list:
    """Every plan on `world` spawned workers: their records."""
    path = tmp_path / "plans.pt"
    torch.save({name: {k: v for k, v in inp.items() if k != "np_states"}
                for name, inp in inputs.items()}, path)
    done = procs.spawn_zone(worker.plans_worker, world, str(path),
                            str(tmp_path), timeout=300)
    assert done == list(range(world))
    out = []
    for rank in range(world):
        with open(tmp_path / f"p{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


WHOLE = ("log", "step", "pending")        # every process holds these whole


def _field(want, got, lo, hi, what):
    """`got` is `want`'s data ranks [lo, hi) (data dim first), or the
    whole of a field every process holds whole."""
    if want is None or got is None:
        assert want is None and got is None, what
    elif isinstance(want, dict):
        assert want.keys() == got.keys(), what
        for k in want:
            _field(want[k], got[k], lo, hi, f"{what}.{k}")
    elif what.startswith(WHOLE):
        _same(want, got, what)
    else:
        _same(np.asarray(want)[lo:hi], got, what)


def _meta(want, got, what):
    """The mirrored window meta: the whole zone's on every process."""
    if want is None or got is None:
        assert want is None and got is None, what
        return
    assert want.keys() == got.keys(), what
    for k in want:
        if k == "digest":
            _same(want[k], got[k], f"{what}.digest")
        else:
            assert want[k] == got[k], (what, k, want[k], got[k])


def _without(rep, key):
    return {k: v for k, v in rep.items() if k != key}


def check_plan(ref, one, parts, mesh_name, name) -> None:
    """Every worker's slice of every field byte-equal to the reference's
    and the one-process port's, phase by phase (the live row, which the
    reference has not, to the one-process port's); reports equal to
    both (a refused footprint: refused on every process, where the
    reference has no check); host figures equal to the one-process
    port's, and those the reference keeps to its; the gathered state is
    the reference's global state."""
    g = MESHES[mesh_name][0][0]
    gl = g // len(parts)
    assert MESHES[mesh_name][1][0] == "data"       # the data dim leads
    assert list(ref) == list(one) + ["state"], name
    for rank, part in enumerate(parts):
        recs = part[name]
        lo, hi = rank * gl, (rank + 1) * gl
        for phase in one:
            what = f"{name} {phase} p{rank}"
            got = recs[phase]
            for src, want in (("reference", ref[phase]), ("one process",
                                                          one[phase])):
                for field, w in want["fields"].items():
                    if field == "meta":
                        _meta(w, got["fields"]["meta"], f"{what} meta")
                    else:
                        _field(w, got["fields"][field], lo, hi,
                               f"{field} ({what} vs {src})")
            assert got["report"] == one[phase]["report"], what
            if "refused" in got["report"]:
                assert "past the" in got["report"]["refused"], what
            assert _without(got["report"], "refused") == ref[phase][
                "report"], what
            assert got["stats"] == one[phase]["stats"], what
            assert {k: got["stats"][k] for k in REF_STATS} == ref[phase][
                "stats"], what
        for k, v in ref["state"].items():
            _same(v.view(np.uint16) if v.dtype.itemsize == 2 else v,
                  recs["state"][k], f"{name} state.{k}")
    for part in parts:
        assert part["exchange"]["sent_bytes"] > 0


def run_case(mesh_name, world, names, tmp_path, cache: dict,
             depth_1=False) -> dict:
    """The plans `names` on `mesh_name` through the reference and the
    one-process port (once per mesh, in `cache`) and on `world` workers,
    held byte-equal; `depth_1`: the drained one-process run at depth 1
    is the one at its own depth, field for field.  Returns the
    one-process records, {name: {phase: record}}."""
    if mesh_name not in cache:
        inputs = plans(mesh_name, names)
        ref = {n: ref_plan(mesh_name, inp) for n, inp in inputs.items()}
        one = {n: worker.one_process(inp) for n, inp in inputs.items()}
        if depth_1:
            for n, inp in inputs.items():
                flat = worker.one_process(inp, pipeline_depth=1)
                for phase, rec in one[n].items():
                    for field, want in flat[phase]["fields"].items():
                        what = f"{field} ({n} {phase} at depth 1)"
                        if field == "meta":
                            _meta(want, rec["fields"][field], what)
                        else:
                            _field(want, rec["fields"][field], 0, None,
                                   what)
        cache[mesh_name] = (inputs, ref, one)
    inputs, ref, one = cache[mesh_name]
    parts = split(inputs, world, tmp_path)
    for name in names:
        check_plan(ref[name], one[name], parts, mesh_name, name)
    return one


def cadence(recs) -> list:
    """(phase, window, attempts since the flush) through a plan."""
    return [(phase, rec["stats"]["window"], rec["stats"]["since"])
            for phase, rec in recs.items()]
