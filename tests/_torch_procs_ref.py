"""The reference side of the split-zone tests (tests/test_torch_procs*.py).

`inputs` makes one case's inputs from a seed: five global states of the
quickstart's three kinds of leaf sized so that every parity owner holds
payload pages (row = 24 pages of 64 words on the (8, 1) and (4, 2)
meshes), the last two a patch of pages with an owner on every rank, and
the fault plan.  `ref_phases` runs `_torch_procs_worker.run_phases`'s
sequence through the reference's Pool; `one_process` runs the port's on
one process; `split` spawns the port's workers.  `check_case` holds each
worker's slice of every field, phase by phase, byte-equal to the
reference's and the one-process port's, and their reports and stats to
theirs.
"""
import pickle

import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import ProtectConfig as RefConfig
from repro.pool import Fault as RefFault
from repro.pool import Pool as RefPool
from repro.runtime import failure as ref_failure
from repro_torch import convert
from repro_torch.core import layout
from repro_torch.dist import procs, sharding
from repro_torch.dist.sharding import ZoneMesh
from tests import _torch_procs_worker as worker
from tests._torch_ref import (MESHES, jax_mesh, jax_specs, port_specs,
                              ref_fields, to_jax, to_torch)

BW = 64
SPECS = {"scale": (), "w_fsdp": ("data", "model"), "w_tp": (None, "model")}
# one page a parity owner (pages // G a rank), all in w_fsdp's words
DIRTY = {"mesh81": [1, 4, 7, 10, 13, 16, 19, 21],
         "mesh42": [2, 8, 14, 19]}
# data rank i's words on a dirty page flip by MASK * (i + 1): mantissa
# bits of each bf16 half and of f32, and a delta that differs by rank (an
# equal one on every rank would cancel in the XOR parity of an even zone)
MASK = 0x00010001


def _state(rng):
    return {"scale": np.float32(rng.standard_normal()),
            "w_fsdp": rng.standard_normal((64, 174)).astype(np.float32),
            "w_tp": np.asarray(jnp.asarray(rng.standard_normal((4, 64)),
                                           jnp.bfloat16))}


def _patched(state_np, mesh_name, pages):
    """`state_np` with every rank's words on `pages` flipped by its mask
    (the payload's only; a data-replicated leaf takes rank 0's): a patch
    whose dirty set is exactly `pages`."""
    shape, axes = MESHES[mesh_name]
    zm, ps = ZoneMesh(shape, axes), port_specs(SPECS)
    st = to_torch(state_np)
    lo = layout.build_layout(st, shape[0], ps, zm, block_words=BW)
    row = layout.flatten_row(lo, {k: sharding.shard(v, ps[k], zm)
                                  for k, v in st.items()})
    mask = torch.zeros(shape[0], 1, row.shape[-1], dtype=torch.int32)
    for i in range(shape[0]):
        for p in pages:
            mask[i, :, p * BW:(p + 1) * BW] = MASK * (i + 1)
    mask[..., lo.payload_words:] = 0
    new = layout.unflatten_row(lo, row ^ mask)
    out = {k: convert._np_leaf(sharding.unshard(v, ps[k], zm))
           for k, v in new.items()}
    out["w_tp"] = out["w_tp"].view(jnp.bfloat16)
    out["scale"] = out["scale"].reshape(())
    return out


def inputs(mesh_name, r, seed=0) -> dict:
    """One case's inputs: `np_states` for the reference, the rest (torch
    states included) for `run_phases`."""
    g = MESHES[mesh_name][0][0]
    rng = np.random.default_rng(seed)
    states = [_state(rng) for _ in range(3)]
    dirty = DIRTY[mesh_name]
    states.append(_patched(states[2], mesh_name, dirty))
    states.append(_patched(states[3], mesh_name, dirty))
    return {
        "np_states": states, "states": [to_torch(s) for s in states],
        "mesh": MESHES[mesh_name], "specs": SPECS, "r": r, "bw": BW,
        "dirty": dirty,
        "lost": g - 1,                          # on the last process
        "multi_lost": [0, g // 2, g - 1][:r] if r >= 2 else None,
        "scribble": (g // 2, 70),               # page 1
        "flip": (1, 300),                       # page 4
        "over_budget": list(range(r + 1)),
    }


def _report(rep):
    return worker.report(rep)


def ref_phases(mesh_name, inp) -> dict:
    """The sequence through the reference's Pool: {phase: record}, and
    the final global state under "state"."""
    mesh = jax_mesh(mesh_name)
    st = [to_jax(s, SPECS, mesh) for s in inp["np_states"]]
    pool = RefPool.open(st[0], jax_specs(SPECS), mesh=mesh,
                        config=RefConfig(mode="mlpc", redundancy=inp["r"],
                                         block_words=BW))
    out = {}

    def rec(phase, rep):
        out[phase] = {"fields": ref_fields(pool.prot, mesh), "report": rep}

    rec("open", {"overhead": pool.overhead_report()})
    with pool.transaction(data_cursor=1) as tx:
        tx.stage(st[1], verify_old=True)
    rec("bulk_verify", {"ok": tx.ok})
    rec("bulk", {"ok": bool(pool.commit(st[2], data_cursor=2))})
    with pool.transaction(data_cursor=3) as tx:
        tx.stage(st[3], dirty_pages=inp["dirty"], verify_old=True)
    rec("patch_verify", {"ok": tx.ok})
    rec("patch", {"ok": bool(pool.commit(st[4], dirty_pages=inp["dirty"],
                                         data_cursor=4))})
    rec("scrub", _report(pool.scrub()))
    rec("precheck", _report(pool.precheck()))
    pool.prot, _ = ref_failure.inject_rank_loss(pool.protector, pool.prot,
                                                inp["lost"])
    rec("rank_loss", _report(pool.recover(RefFault.rank_loss(inp["lost"]))))
    if inp["r"] >= 2:
        pool.prot, _ = ref_failure.inject_multi_rank_loss(
            pool.protector, pool.prot, inp["multi_lost"])
        rec("multi_loss", _report(pool.recover(
            RefFault.multi_loss(*inp["multi_lost"]))))
    rank, word = inp["scribble"]
    pool.prot, _ = ref_failure.inject_scribble(pool.protector, pool.prot,
                                               rank, [word])
    rec("scribble_scrub", _report(pool.scrub()))
    rank, word = inp["flip"]
    pool.prot, _ = ref_failure.inject_scribble(pool.protector, pool.prot,
                                               rank, [word])
    pre = _report(pool.precheck())
    rec("flip_precheck", {"precheck": pre, "recover": _report(pool.recover(
        RefFault.scribble(rank, [word // BW])))})
    zeros = {k: jnp.zeros_like(v) for k, v in st[4].items()}
    with pool.transaction() as tx:
        tx.watch(ref_failure.smashed_canary_buffer(256))
        tx.stage(zeros)
    rec("canary", {"aborted": tx.aborted, "ok": tx.ok})
    try:
        pool.recover(RefFault.multi_loss(*inp["over_budget"]))
        refused = None
    except RuntimeError as err:
        refused = str(err)
    rec("over_budget", {"refused": refused})
    out["state"] = {k: np.asarray(v) for k, v in pool.state.items()}
    return out


def one_process(inp) -> dict:
    """The port's sequence on one process: {phase: record}."""
    shape, axes = inp["mesh"]
    return {phase: worker.record(pool, rep) for phase, pool, rep in
            worker.run_phases(ZoneMesh(shape, axes), inp, smash=True)}


def split(inp, world, tmp_path) -> list:
    """The port's sequence on `world` spawned workers: their records."""
    path = tmp_path / "inputs.pt"
    torch.save({k: v for k, v in inp.items() if k != "np_states"}, path)
    done = procs.spawn_zone(worker.zone_worker, world, str(path),
                            str(tmp_path), timeout=300)
    assert done == list(range(world))
    out = []
    for rank in range(world):
        with open(tmp_path / f"p{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _same(want, got, what):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, f"{what}: {want.shape} vs {got.shape}"
    assert want.tobytes() == got.tobytes(), f"{what}: bytes differ"


def _block(want, got, lo, hi, what):
    """`got` is `want`'s data ranks [lo, hi) (data dim first), or, for a
    field every process holds whole (the log, the step), `want` itself."""
    if want is None or got is None:
        assert want is None and got is None, what
    elif isinstance(want, dict):
        assert want.keys() == got.keys(), what
        for k in want:
            _block(want[k], got[k], lo, hi, f"{what}.{k}")
    elif what.startswith(("log", "step")):
        _same(want, got, what)
    else:
        _same(np.asarray(want)[lo:hi], got, what)


def check_case(ref, one, parts, mesh_name) -> None:
    """Every worker's slice of every field byte-equal to the reference's
    and the one-process port's, phase by phase; reports equal to the
    reference's, stats to the one-process port's; the gathered state is
    the reference's global state."""
    g = MESHES[mesh_name][0][0]
    gl = g // len(parts)
    assert MESHES[mesh_name][1][0] == "data"       # the data dim leads
    assert list(ref) == list(one) + ["state"]
    for rank, part in enumerate(parts):
        lo, hi = rank * gl, (rank + 1) * gl
        for phase in one:
            for name, want in (("reference", ref[phase]["fields"]),
                               ("one process", one[phase]["fields"])):
                for field in want:
                    _block(want[field], part[phase]["fields"][field], lo,
                           hi, field)
            if phase != "over_budget":      # the messages differ in words
                assert part[phase]["report"] == ref[phase]["report"], phase
            assert part[phase]["report"] == one[phase]["report"], phase
            assert part[phase]["stats"] == one[phase]["stats"], phase
        for k, v in ref["state"].items():
            _same(v.view(np.uint16) if v.dtype.itemsize == 2 else v,
                  part["state"][k], f"state.{k}")
        assert part["exchange"]["sent_bytes"] > 0


def run_case(mesh_name, r, world, tmp_path, ref_cache: dict) -> None:
    key = (mesh_name, r)
    if key not in ref_cache:
        inp = inputs(mesh_name, r)
        ref_cache[key] = (inp, ref_phases(mesh_name, inp), one_process(inp))
    inp, ref, one = ref_cache[key]
    assert ref["over_budget"]["report"]["refused"]
    check_case(ref, one, split(inp, world, tmp_path), mesh_name)
