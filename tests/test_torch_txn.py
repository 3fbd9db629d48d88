"""The port's synchronous Protector against the reference's, step by step:
init, then bulk ± verify, patch ± verify, metadata-only, a canary abort
and a verify abort, in every protection mode, on mesh42 and mesh_pod.
After every step each field — the state shards, row, synd, cksums,
digest, redo log, step — and the verdict are byte-equal to the
reference's.  The streamed route (row >= stream_threshold_words) runs
against the reference's streamed Protector with the same settings."""
import jax
import numpy as np
import pytest
import torch

from repro.runtime import failure as ref_failure
from repro_torch.runtime import failure
from tests._torch_ref import Pair, assert_prot_same, patched, state_like, \
    to_jax
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("mesh_name", ["mesh42", "mesh_pod"])
@pytest.mark.parametrize("mode", ["mlpc", "mlp"])
def test_commit_paths_match_reference(mesh_name, mode):
    pr = Pair(mesh_name, mode)
    # layout at bw = 64: w1 fills page 0, w2 pages 1-2, scale page 3
    assert pr.commit(state_like(1, pr.cur), seed=1)                    # bulk
    assert pr.commit(state_like(2, pr.cur), seed=2, verify_old=True)   # bulk+v
    w1 = state_like(3, pr.cur)["w1"]
    assert pr.commit(patched(pr.cur, w1=w1), seed=3, dirty_pages=[0])
    sc = state_like(4, pr.cur)["scale"]
    assert pr.commit(patched(pr.cur, scale=sc), seed=4, dirty_pages=[3],
                     verify_old=True)                              # patch+v
    assert pr.commit(dict(pr.cur), seed=5, dirty_pages=[])         # meta
    assert not pr.commit(state_like(6, pr.cur), seed=6, canary_ok=False)
    assert not pr.commit(state_like(7, pr.cur), seed=7, canary_ok=False,
                         verify_old=True)


@pytest.mark.parametrize("dirty", [None, [0]])
def test_verify_abort_on_scribbled_state_matches_reference(dirty):
    """A scribble in the live state fails verify-at-open; the commit aborts
    in every zone and leaves the (scribbled) state and the protection as
    the reference leaves them."""
    pr = Pair("mesh42", "mlpc")
    pr.rp, _ = ref_failure.inject_scribble(pr.ref, pr.rp, rank=1,
                                           word_offsets=[5])
    pr.pp, _ = failure.inject_scribble(pr.port, pr.pp, rank=1,
                                       word_offsets=[5])
    pr.check()
    w1 = state_like(8, pr.cur)["w1"]
    assert not pr.commit(patched(pr.cur, w1=w1), seed=8, verify_old=True,
                         dirty_pages=dirty)


def test_zone_agreement_spans_the_data_axis_only():
    """Stored terms that mismatch on model coordinate 1 only: the zones at
    model 1 abort while those at model 0 commit, and the host sees the
    verdict of mesh coordinate 0 (True) — the reference's `_zone_clean`
    takes its pmin over the data axis only, so one transaction partially
    commits.  The port reproduces that exactly."""
    pr = Pair("mesh42", "mlpc")
    bad = np.asarray(pr.rp.cksums).copy()
    bad[2, 1, 0, 0] ^= 1
    pr.rp.cksums = jax.device_put(bad, pr.rp.cksums.sharding)
    pr.pp.cksums = pr.pp.cksums.clone()
    pr.pp.cksums[2, 1, 0, 0] ^= 1
    assert pr.commit(state_like(9, pr.cur), seed=9, verify_old=True,
                     dirty_pages=[0, 1, 2, 3])
    row = pr.pp.row
    w1_new = pr.zone(state_like(9, pr.cur))["w1"]
    assert torch.equal(pr.pp.state["w1"][:, 0], w1_new[:, 0])
    assert not torch.equal(pr.pp.state["w1"][:, 1], w1_new[:, 1])
    assert row.shape[:2] == (4, 2)


@pytest.mark.parametrize("mode", ["none", "ml", "replica"])
def test_unprotected_modes_match_reference(mode):
    pr = Pair("mesh42", mode)
    assert pr.commit(state_like(1, pr.cur), seed=1)
    assert not pr.commit(state_like(2, pr.cur), seed=2, canary_ok=False)
    assert pr.commit(state_like(3, pr.cur), seed=3, dirty_pages=[0])


@pytest.mark.parametrize("mode", ["mlpc", "mlp"])
def test_streamed_route_matches_reference(mode):
    """stream_threshold_words=1 forces the streamed kernels (the digest
    comes from the kernel, not from combine) — same bytes."""
    pr = Pair("mesh42", mode, stream_threshold_words=1, stream_chunk_words=128)
    assert pr.port.stream_chunk() == 2
    assert pr.commit(state_like(1, pr.cur), seed=1)
    assert pr.commit(state_like(2, pr.cur), seed=2, verify_old=True)
    w1 = state_like(3, pr.cur)["w1"]
    assert pr.commit(patched(pr.cur, w1=w1), seed=3, dirty_pages=[0],
                     verify_old=True)


def test_recovery_and_scrub_match_reference():
    pr = Pair("mesh_pod", "mlpc")
    pr.commit(state_like(1, pr.cur), seed=1)
    for lost in (0, 1):
        rp, _ = ref_failure.inject_rank_loss(pr.ref, pr.rp, lost)
        pp, _ = failure.inject_rank_loss(pr.port, pr.pp, lost)
        assert_prot_same(rp, pr.mesh, pp)
        rp, rok = pr.ref.recover_rank(rp, lost)
        pp, pok = pr.port.recover_rank(pp, lost)
        assert bool(rok) and bool(pok)
        assert_prot_same(rp, pr.mesh, pp)
    # words 3 and 200 lie in different parity segments (seg = 192 words),
    # so the pre-check's folds cannot cancel
    rp, _ = ref_failure.inject_scribble(pr.ref, pr.rp, 1, [3, 200])
    pp, _ = failure.inject_scribble(pr.port, pr.pp, 1, [3, 200])
    rs, ps = pr.ref.scrub(rp), pr.port.scrub(pp)
    np.testing.assert_array_equal(np.asarray(rs["bad_pages"]),
                                  ps["bad_pages"].numpy())
    np.testing.assert_array_equal(np.asarray(rs["synd_ok"]),
                                  ps["synd_ok"].numpy())
    assert bool(rs["row_cache_ok"]) == bool(ps["row_cache_ok"]) is False
    rl, pl = pr.ref.local_scrub(rp), pr.port.local_scrub(pp)
    # 2 bad pages on data rank 1 of each of the 4 zones
    assert int(rl["bad_count"]) == int(pl["bad_count"]) == 8
    assert bool(rl["synd_ok"][0]) == bool(pl["synd_ok"][0]) is False
    rp, rok = pr.ref.repair_pages(rp, [1, 1], [0, 3])
    pp, pok = pr.port.repair_pages(pp, [1, 1], [0, 3])
    assert bool(rok) and bool(pok)
    assert_prot_same(rp, pr.mesh, pp)
    assert pr.port.overhead_report() == pr.ref.overhead_report()


def test_seeded_injectors_pick_the_reference_victims():
    pr = Pair("mesh42", "mlpc")
    for seed in (0, 3):
        assert failure.scribble_plan(pr.port, seed) == \
            ref_failure.scribble_plan(pr.ref, seed)
        rp, rev = ref_failure.seeded_scribble(pr.ref, pr.rp, seed)
        pp, pev = failure.seeded_scribble(pr.port, pr.pp, seed)
        assert pev.locations == rev.locations
        assert_prot_same(rp, pr.mesh, pp)
        rp, rev = ref_failure.seeded_rank_loss(pr.ref, pr.rp, seed)
        pp, pev = failure.seeded_rank_loss(pr.port, pr.pp, seed)
        assert pev.lost_rank == rev.lost_rank
        assert_prot_same(rp, pr.mesh, pp)


def test_state_carried_across_from_the_reference():
    """convert.to_port takes the reference's state mid-run; the next
    commits then land byte-equal on both sides."""
    from repro_torch import convert
    from tests._torch_ref import ref_fields
    pr = Pair("mesh_pod", "mlpc")
    pr.rp, _ = pr.ref.commit(pr.rp, to_jax(state_like(1, pr.cur), pr.specs,
                                           pr.mesh))
    pr.cur = state_like(1, pr.cur)
    pr.pp = convert.to_port(ref_fields(pr.rp, pr.mesh), device="cpu")
    pr.check()
    assert pr.commit(state_like(2, pr.cur), seed=2, verify_old=True)
    assert pr.commit(patched(pr.cur, w1=state_like(3, pr.cur)["w1"]), seed=3,
                     dirty_pages=[0], verify_old=True)
