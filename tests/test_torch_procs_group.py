"""`PoolGroup` and its rescale walk on a zone split over processes: W in
{2, 4} on the (8, 1) mesh and 2 on (4, 2), four synchronous tenants and
two window-2 tenants (mlpc, r = 3).  The plan
(tests/_torch_procs_hosts_worker.py `group_plan`): admission, a wave with
one canary failing, a verified wave in which the deferred tenants' window
flushes, a scribble on a rank of the last process found by `scrub_tick`
and recovered under quarantine, a rank loss recovered beside an async
wave of the other tenants, an eviction, and a rescale to the other mesh
and back with a wave after each.  After every phase each worker's block
of every tenant's fields (the open window's too) is byte-equal to the
one-process port's, its verdicts, findings, reports and host figures
equal; the one-process port's are the reference's PoolGroup's, fed the
same states.  Every tenant's states differ by rank (random w_fsdp
shards).  A rescale that keeps another process's block, and a quarantine
decided on a finding one process alone holds, fail."""
import functools

import jax
import numpy as np
import pytest

from repro.configs.base import ProtectConfig as RefConfig
from repro.pool import Fault as RefFault
from repro.runtime import failure as ref_failure
from repro.tenancy import PoolGroup as RefGroup
from repro_torch import ZoneMesh
from repro_torch.dist import procs
from tests import _torch_procs_hosts_worker as hw
from tests._torch_procs_ref import BW, SPECS, _state
from tests._torch_procs_window_ref import _field, _meta, _ref_record
from tests._torch_ref import MESHES, jax_mesh, jax_specs, to_jax, to_torch
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

R = 3
WAVES = 7                  # each tenant's states: admission + six waves
OTHER = {"mesh81": "mesh42", "mesh42": "mesh81"}


@functools.lru_cache(maxsize=None)
def inputs(mesh_name):
    """(numpy states for the reference, the plan's inputs)."""
    g = MESHES[mesh_name][0][0]
    rng = np.random.default_rng(7)
    np_states = {t: [_state(rng) for _ in range(WAVES)]
                 for t in hw.SYNC + hw.DEFERRED}
    inp = {"mesh": MESHES[mesh_name], "specs": SPECS, "r": R, "bw": BW,
           "states": {t: [to_torch(s) for s in ss]
                      for t, ss in np_states.items()},
           "scribble": (g - 1, 70),            # the last process's rank
           "lost": g - 3,                      # off process 0
           "walk": [MESHES[OTHER[mesh_name]][0], MESHES[mesh_name][0]]}
    return np_states, inp


def sizes(mesh_name) -> dict:
    other = MESHES[OTHER[mesh_name]][0][0]
    return {None: MESHES[mesh_name][0][0], "rescale_0": other,
            "wave_after_rescale_0": other}


@functools.lru_cache(maxsize=None)
def one_process(mesh_name) -> dict:
    _, inp = inputs(mesh_name)
    shape, axes = inp["mesh"]
    return hw.run("group", ZoneMesh(shape, axes), inp)


def ref_plan(mesh_name) -> dict:
    """`group_plan` through the reference's PoolGroup: {phase: {tid:
    record}, host values}."""
    np_states, inp = inputs(mesh_name)
    mesh = jax_mesh(mesh_name)
    grp = RefGroup(mesh, full_scrub_every=1)
    for tid in hw.SYNC + hw.DEFERRED:
        grp.admit(tid, to_jax(np_states[tid][0], SPECS, mesh),
                  jax_specs(SPECS), config=RefConfig(
                      mode="mlpc", redundancy=R, block_words=BW,
                      window=2 if tid in hw.DEFERRED else 1))
    out = {}

    def rec(phase, extra=None):
        out[phase] = ({t: _ref_record(grp[t].pool, None, mesh)
                       for t in grp.tenants}, extra or {})

    def wave(i, **kw):
        oks = grp.commit({t: to_jax(np_states[t][i], SPECS, mesh)
                          for t in grp.tenants}, data_cursor=i, **kw)
        return {t: bool(jax.device_get(v)) for t, v in oks.items()}
    rec("admit")
    rec("wave_t2_canary", wave(1, canary_ok={t: t != "t2"
                                             for t in grp.tenants}))
    rec("verified_wave_flush", wave(2, verify_old=True))
    rank, word = inp["scribble"]
    pool = grp["t1"].pool
    pool.prot, _ = ref_failure.inject_scribble(pool.protector, pool.prot,
                                               rank, [word])
    found, recovered = [], []
    for tid, kind, rep in grp.scrub_tick():
        locs = [tuple(int(v) for v in loc) for loc in rep.bad_locations]
        found.append((tid, kind, locs))
        if locs:
            r = grp.recover(tid, RefFault.scribble(
                locs[0][0], sorted({pg for _, pg in locs})))
            recovered.append((tid, bool(r.verified)))
    rec("scrub_tick_quarantine", {"found": found, "recovered": recovered})
    pool = grp["t3"].pool
    pool.prot, _ = ref_failure.inject_rank_loss(pool.protector, pool.prot,
                                                inp["lost"])
    ticket = grp.commit_async({t: to_jax(np_states[t][3], SPECS, mesh)
                               for t in grp.tenants if t != "t3"},
                              data_cursor=3)
    r = grp.recover("t3", RefFault.rank_loss(inp["lost"]))
    grp.drain()
    rec("recover_t3_beside_a_wave", {"verified": bool(r.verified),
                                     "wave": bool(ticket.result())})
    evicted = grp.evict("t0")
    rec("evict_t0", {"evicted": {k: np.asarray(v)
                                 for k, v in evicted.items()}})
    for j, name in enumerate((OTHER[mesh_name], mesh_name)):
        mesh = jax_mesh(name)
        grp = grp.rescale(mesh)
        rec(f"rescale_{j}")
        rec(f"wave_after_rescale_{j}", wave(4 + j))
    return out


def test_one_process_group_is_the_reference():
    """The one-process port's records, phase by phase, are the
    reference's PoolGroup's: every tenant's fields byte-equal (the open
    window's, its mirrored meta), verdicts, findings and recoveries
    equal, the evicted state the reference's."""
    name = "mesh81"
    ref, one = ref_plan(name), one_process(name)
    assert list(ref) == [p for p in one if p != "state"]
    for phase, (tenants, extra) in ref.items():
        got = one[phase]
        assert list(tenants) == list(got["pools"]), phase
        for tid, want in tenants.items():
            fields = got["pools"][tid]["fields"]
            for field, w in want["fields"].items():
                what = f"{field} ({phase} {tid})"
                if field == "meta":
                    _meta(w, fields["meta"], what)
                else:
                    _field(w, fields[field], 0, None, what)
            for k in ("window", "commits", "aborted_commits", "scrub"):
                assert got["pools"][tid]["stats"][k] == want["stats"][k], (
                    phase, tid, k)
        ex = got["extra"]
        if phase.startswith("wave") or phase == "verified_wave_flush":
            assert ex == extra, phase
        if phase == "scrub_tick_quarantine":
            assert ex["found"] == extra["found"]
            assert [(t, r["verified"]) for t, r in ex["recovered"]] == \
                extra["recovered"]
            assert extra["recovered"] == [("t1", True)]
        if phase == "recover_t3_beside_a_wave":
            assert ex["recovered"]["verified"] == extra["verified"] is True
            assert ex["wave"] == extra["wave"] is True
        if phase == "evict_t0":
            for k, v in extra["evicted"].items():
                v = v.view(np.uint16) if v.dtype.itemsize == 2 else v
                assert v.tobytes() == ex["evicted"][k].tobytes(), k


@pytest.mark.parametrize("mesh_name,world", [
    ("mesh81", 2), ("mesh81", 4), ("mesh42", 2)])
def test_split_group_is_byte_equal(mesh_name, world, tmp_path):
    """Every worker's block of every tenant, phase by phase, through the
    rescale walk, byte-equal to the one-process group's."""
    _, inp = inputs(mesh_name)
    one = one_process(mesh_name)
    assert one["wave_t2_canary"]["extra"]["t2"] is False
    assert one["scrub_tick_quarantine"]["extra"]["found"][1][2]
    hw.check_parts(one, hw.split("group", inp, world, tmp_path),
                   sizes(mesh_name))


def test_a_rescale_keeping_another_block_fails(tmp_path):
    """A reshard that keeps the next process's block of the new mesh
    (a wrong data offset) is caught at the rescale."""
    _, inp = inputs("mesh81")
    parts = hw.split("group", inp, 2, tmp_path, mutation="wrong_offset")
    with pytest.raises(AssertionError, match="rescale_0"):
        hw.check_parts(one_process("mesh81"), parts, sizes("mesh81"))


def test_a_quarantine_on_an_unagreed_finding_fails(tmp_path):
    """A quarantine decided on the finding only the scribbled rank's
    process holds sends the processes into different exchanges: the
    workers fail (a mismatched or timed-out collective)."""
    _, inp = inputs("mesh81")
    with pytest.raises((procs.ZoneError, AssertionError)):
        parts = hw.split("group", inp, 2, tmp_path,
                         mutation="unagreed_quarantine", group_timeout=15)
        hw.check_parts(one_process("mesh81"), parts, sizes("mesh81"))
