"""The kernels' plain versions (the CPU path of kernels/ops.py) against the
reference's Pallas kernels run in interpret mode AND against kernels/ref.py,
byte for byte, on the same seeded pages; the zone-stacked batched call
against one reference call per rank.  The CUDA kernels themselves are
held against these plain versions on the card (test_torch_cuda.py)."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import commit_fused, fletcher, ref
from repro_torch.kernels import _build, ops
from repro_torch.kernels import commit_fused as port_cf
from repro_torch.kernels import fletcher as port_fl
from repro_torch.kernels import gf_parity as port_gf
from tests._torch_ref import as_words, rand_u32, words
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

GEOMS = [(n, bw) for bw in (64, 1024) for n in (1, 3, 8, 13)]


def _inputs(n, bw, seed):
    old, new = rand_u32((n, bw), seed), rand_u32((n, bw), seed + 1)
    stored = np.asarray(ref.fletcher_blocks_ref(jnp.asarray(old))).copy()
    stored[::3, 0] ^= 1                    # a few corrupted stored rows
    return old, new, stored


def _eq(got, *wants):
    for want in wants:
        np.testing.assert_array_equal(
            words(got) if got.dtype == torch.int32 else got.numpy(),
            np.asarray(want))


@pytest.mark.parametrize("n,bw", GEOMS)
def test_fletcher_plain_vs_pallas_and_ref(n, bw):
    x = rand_u32((n, bw), seed=n * bw)
    j = jnp.asarray(x)
    terms = ops.fletcher_blocks(as_words(x))
    # the flat Pallas kernel tiles 8 pages and needs n % min(8, n) == 0;
    # its streamed sibling takes any n and emits the same terms
    pallas = (fletcher.fletcher_blocks(j, interpret=True)
              if n % min(8, n) == 0 else
              fletcher.fletcher_stream(j, chunk_blocks=4, interpret=True)[0])
    _eq(terms, pallas, ref.fletcher_blocks_ref(j))
    terms_s, dig = ops.fletcher_stream(as_words(x), chunk_blocks=4)
    p_terms, p_dig = fletcher.fletcher_stream(j, chunk_blocks=4,
                                              interpret=True)
    r_terms, r_dig = ref.fletcher_stream_ref(j)
    _eq(terms_s, p_terms, r_terms)
    _eq(dig, p_dig, r_dig)


@pytest.mark.parametrize("n,bw", GEOMS)
def test_fused_commit_family_plain_vs_pallas_and_ref(n, bw):
    old, new, stored = _inputs(n, bw, seed=7 * n + bw)
    jo, jn, js = jnp.asarray(old), jnp.asarray(new), jnp.asarray(stored)
    to, tn, ts = as_words(old), as_words(new), as_words(stored)

    for got, p, r in zip(ops.fused_commit(to, tn),
                         commit_fused.fused_commit(jo, jn, interpret=True),
                         ref.fused_commit_ref(jo, jn)):
        _eq(got, p, r)
    for got, p, r in zip(
            ops.fused_verify_commit(to, tn, ts),
            commit_fused.fused_verify_commit(jo, jn, js, interpret=True),
            ref.fused_verify_commit_ref(jo, jn, js)):
        _eq(got, p, r)
    for got, p, r in zip(
            ops.fused_commit_old_terms(to, tn),
            commit_fused.fused_commit_old_terms(jo, jn, interpret=True),
            ref.fused_commit_old_terms_ref(jo, jn)):
        _eq(got, p, r)
    for got, p, r in zip(
            ops.fused_verify_commit_stream(to, tn, ts, chunk_blocks=4),
            commit_fused.fused_verify_commit_stream(jo, jn, js, chunk_blocks=4,
                                                    interpret=True),
            ref.fused_verify_commit_stream_ref(jo, jn, js)):
        _eq(got, p, r)


@pytest.mark.parametrize("n,bw", GEOMS)
def test_streamed_commit_and_old_terms_plain_vs_pallas_and_ref(n, bw):
    """`fused_commit_stream` and `fused_commit_old_terms_stream`, which no
    engine path of the reference calls, held to its Pallas kernels too."""
    old, new, _ = _inputs(n, bw, seed=11 * n + bw)
    jo, jn = jnp.asarray(old), jnp.asarray(new)
    to, tn = as_words(old), as_words(new)
    for got, p, r in zip(
            ops.fused_commit_stream(to, tn),
            commit_fused.fused_commit_stream(jo, jn, chunk_blocks=4,
                                             interpret=True),
            ref.fused_commit_stream_ref(jo, jn), strict=True):
        _eq(got, p, r)
    for got, p, r in zip(
            ops.fused_commit_old_terms_stream(to, tn),
            commit_fused.fused_commit_old_terms_stream(
                jo, jn, chunk_blocks=4, interpret=True),
            ref.fused_commit_old_terms_stream_ref(jo, jn), strict=True):
        _eq(got, p, r)


def test_zone_stacked_call_equals_per_rank_calls():
    """(R, n, bw) pages in one call == R separate reference calls; each
    rank's digest covers its own pages only."""
    r_, n, bw = 6, 5, 64
    old, new = rand_u32((r_, n, bw), 1), rand_u32((r_, n, bw), 2)
    stored = rand_u32((r_, n, 2), 3)
    terms, dig = ops.fletcher_stream(as_words(new))
    delta, ck, bad, dig_v = ops.fused_verify_commit_stream(
        as_words(old), as_words(new), as_words(stored))
    for i in range(r_):
        jo, jn, js = (jnp.asarray(old[i]), jnp.asarray(new[i]),
                      jnp.asarray(stored[i]))
        w_terms, w_dig = ref.fletcher_stream_ref(jn)
        _eq(terms[i], w_terms)
        _eq(dig[i], w_dig)
        for got, want in zip((delta[i], ck[i], bad[i], dig_v[i]),
                             ref.fused_verify_commit_stream_ref(jo, jn, js)):
            _eq(got, want)


def test_stream_chunk_blocks_policy():
    """Rows at or above the threshold stream; a chunk never exceeds the
    row; the policy is the reference's."""
    from repro.kernels import ops as ref_ops
    for n, thr, chunk in [(4, 1, 1 << 16), (4, 256, 32), (4, 0, 128),
                          (4, 1, 128), (4, 1 << 20, 128), (2600, 1 << 20,
                                                           1 << 16)]:
        kw = dict(threshold_words=thr, chunk_words=chunk)
        assert ops.stream_chunk_blocks(n, 1024, **kw) == \
            ref_ops.stream_chunk_blocks(n, 1024, **kw)
    assert ops.stream_chunk_blocks(4, 64, threshold_words=1,
                                   chunk_words=1 << 16) == 4
    assert ops.stream_chunk_blocks(4, 64, threshold_words=256,
                                   chunk_words=32) == 1
    assert ops.stream_chunk_blocks(4, 64, threshold_words=0,
                                   chunk_words=128) is None
    assert ops.stream_chunk_blocks(4, 64, threshold_words=1,
                                   chunk_words=128) == 2
    assert ops.stream_chunk_blocks(4, 64, threshold_words=1 << 20,
                                   chunk_words=128) is None


def test_cuda_wrappers_refuse_what_they_cannot_launch():
    """The CUDA wrappers never fall back: a CPU tensor, a wrong dtype or a
    ragged page width raises before any build or launch."""
    x = torch.zeros(2, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_fl.fletcher_pages_cuda(x, digest=False, name="fletcher_blocks")
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_cf.commit_pages_cuda(x, x, digest=False, name="fused_commit")
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_cf.commit_pages_cuda(x, x, old_terms=True, digest=False,
                                  name="fused_commit_old_terms")
    meta = ops.fletcher_blocks(torch.zeros(2, 64, dtype=torch.int32,
                                           device="meta"))
    assert meta.is_meta and meta.shape == (2, 2) and meta.dtype == torch.int32
    with pytest.raises(ValueError, match="int32 words"):
        ops.fletcher_blocks(torch.zeros(2, 64, device="meta"))
    with pytest.raises(ValueError, match="no protection kernel"):
        ops._on_card(types.SimpleNamespace(device=torch.device("xpu")))


def test_gf_cuda_wrappers_refuse_what_they_cannot_launch():
    x = torch.zeros(2, 64, dtype=torch.int32)
    co = torch.ones(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_gf.syndrome_pages_cuda(x, x, torch.ones(3, dtype=torch.int32),
                                    digest=False, name="fused_commit_s")
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_gf.sdelta_stack_cuda(x, co, name="sdelta_stack")
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_gf.gf_scale_cuda(x, 3, name="gf_scale")
    meta = ops.gf_scale(torch.zeros(2, 64, dtype=torch.int32,
                                    device="meta"), 3)
    assert meta.is_meta and meta.shape == (2, 64)
    with pytest.raises(ValueError, match="int32 words"):
        ops.gf_scale(torch.zeros(2, 64, device="meta"), 3)


def test_library_path_hashes_every_included_header(tmp_path, monkeypatch):
    """An edit to a shared header (gf.cuh, pages.cuh) changes the library
    path of every source that includes it, and of no other.  Every source
    includes pages.cuh; only gf_parity.cu includes gf.cuh."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    assert [f.name for f in _build.compiled_files("gf_parity")] == [
        "gf_parity.cu", "pages.cuh", "gf.cuh"]
    assert [f.name for f in _build.compiled_files("fletcher")] == [
        "fletcher.cu", "pages.cuh"]
    (csrc / "gf.cuh").write_bytes((csrc / "gf.cuh").read_bytes() + b"\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert after["gf_parity"] != before["gf_parity"]
    for name in ("commit_fused", "fletcher", "xor_parity"):
        assert after[name] == before[name]
    (csrc / "pages.cuh").write_bytes(b"// edited\n" +
                                     (csrc / "pages.cuh").read_bytes())
    again = {n: _build.library_path(n) for n in _build.SOURCES}
    for name in _build.SOURCES:
        assert again[name] != after[name]
