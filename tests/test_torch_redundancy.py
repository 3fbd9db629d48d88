"""The port's Protector at redundancy r = 2 and r = 3 against the
reference's, step by step: every commit path (flat and streamed, with and
without verify, bulk, patch and metadata-only, mlp and mlpc, on mesh42
and mesh81), a verify abort, and the state carried over from the
reference.  After every step each protected field, the
(*mesh_dims, r, seg) syndrome stack included, is byte-equal to the
reference's.  Recovery at r >= 2 is in test_torch_multi_loss.py."""
import pytest

from repro.runtime import failure as ref_failure
from repro_torch import convert
from repro_torch.runtime import failure
from tests._torch_ref import (Pair, patched, ref_fields, state_like,
                              to_jax)
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _all_paths(pr, seed0=0, *, canary=True):
    """bulk, bulk + verify, patch, patch + verify, metadata only, a canary
    abort; every step byte-equal (Pair.commit checks)."""
    assert pr.commit(state_like(seed0 + 1, pr.cur), seed=seed0 + 1)
    assert pr.commit(state_like(seed0 + 2, pr.cur), seed=seed0 + 2,
                     verify_old=True)
    w1 = state_like(seed0 + 3, pr.cur)["w1"]
    assert pr.commit(patched(pr.cur, w1=w1), seed=seed0 + 3, dirty_pages=[0])
    sc = state_like(seed0 + 4, pr.cur)["scale"]
    assert pr.commit(patched(pr.cur, scale=sc), seed=seed0 + 4,
                     dirty_pages=[3], verify_old=True)
    assert pr.commit(dict(pr.cur), seed=seed0 + 5, dirty_pages=[])
    if canary:
        assert not pr.commit(state_like(seed0 + 6, pr.cur), seed=seed0 + 6,
                             canary_ok=False)


@pytest.mark.parametrize("mesh_name,mode,r", [
    ("mesh42", "mlpc", 2), ("mesh42", "mlp", 3), ("mesh81", "mlpc", 3),
    ("mesh81", "mlp", 2)])
def test_commit_paths_match_reference(mesh_name, mode, r):
    pr = Pair(mesh_name, mode, redundancy=r)
    assert pr.pp.synd.shape[-2] == r
    _all_paths(pr)


@pytest.mark.parametrize("mode,r", [("mlpc", 3), ("mlp", 2)])
def test_streamed_route_matches_reference(mode, r):
    """stream_threshold_words=1 forces the streamed sweeps: the verified
    bulk commit takes fused_verify_commit_s_stream (its digest from the
    kernel), the plain bulk commit fletcher_stream + the weighted build."""
    pr = Pair("mesh42", mode, redundancy=r, stream_threshold_words=1,
              stream_chunk_words=128)
    assert pr.port.stream_chunk() == 2
    _all_paths(pr, 10, canary=False)


def test_verify_abort_on_scribbled_state_matches_reference():
    pr = Pair("mesh42", "mlpc", redundancy=2)
    pr.rp, _ = ref_failure.inject_scribble(pr.ref, pr.rp, rank=1,
                                           word_offsets=[5])
    pr.pp, _ = failure.inject_scribble(pr.port, pr.pp, rank=1,
                                       word_offsets=[5])
    pr.check()
    w1 = state_like(8, pr.cur)["w1"]
    assert not pr.commit(patched(pr.cur, w1=w1), seed=8, verify_old=True,
                         dirty_pages=[0])
    assert not pr.commit(state_like(9, pr.cur), seed=9, verify_old=True)


def test_state_carried_across_from_the_reference_at_r3():
    """convert carries the (*mesh_dims, 3, seg) stack both ways; the next
    commits then land byte-equal on both sides."""
    pr = Pair("mesh42", "mlpc", redundancy=3)
    new = state_like(1, pr.cur)
    pr.rp, _ = pr.ref.commit(pr.rp, to_jax(new, pr.specs, pr.mesh))
    pr.cur = new
    fields = ref_fields(pr.rp, pr.mesh)
    assert fields["synd"].shape == (4, 2, 3, 64)
    pr.pp = convert.to_port(fields, device="cpu")
    pr.check()
    back = convert.from_port(pr.pp)
    assert back["synd"].tobytes() == fields["synd"].tobytes()
    assert pr.commit(state_like(2, pr.cur), seed=2, verify_old=True)
    assert pr.commit(patched(pr.cur, w1=state_like(3, pr.cur)["w1"]), seed=3,
                     dirty_pages=[0], verify_old=True)
