"""The deferred engine's kernels (PERF.md §6 rows 5, 8 and 13): the plain
versions (the CPU path of kernels/ops.py) against the reference's Pallas
kernels run in interpret mode AND against kernels/ref.py, byte for byte,
on the same seeded words; the zone-stacked call against one reference
call per rank; the wrappers' refusals.  The CUDA kernels are held against
these plain versions on the card (test_torch_cuda.py, chip_smoke.py)."""
import types

import jax.numpy as jnp
import pytest
import torch

from repro.kernels import commit_fused, ref, xor_parity
from repro_torch.kernels import _build, ops
from repro_torch.kernels import commit_fused as port_cf
from repro_torch.kernels import xor_parity as port_xor
from tests._torch_ref import as_words, check_outputs, rand_u32
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _accum_inputs(shape, seed):
    return [rand_u32(shape, seed + i) for i in range(3)]   # acc, old, new


# the flat Pallas kernel tiles 8 pages (n % min(8, n) == 0); the streamed
# one takes any n, here in chunks of 4 that leave a ragged tail at n = 13
@pytest.mark.parametrize("n,bw", [(1, 64), (8, 128), (16, 1024)])
def test_fused_accum_commit_plain_vs_pallas_and_ref(n, bw):
    acc, old, new = _accum_inputs((n, bw), seed=n + bw)
    j = [jnp.asarray(a) for a in (acc, old, new)]
    t = [as_words(a) for a in (acc, old, new)]
    got = ops.fused_accum_commit(*t)
    check_outputs(got, commit_fused.fused_accum_commit(*j, interpret=True),
                  ref.fused_accum_commit_ref(*j))
    assert torch.equal(t[0], as_words(acc)), "acc must not be written"


@pytest.mark.parametrize("n,bw", [(1, 64), (13, 128), (16, 1024)])
def test_fused_accum_commit_stream_plain_vs_pallas_and_ref(n, bw):
    acc, old, new = _accum_inputs((n, bw), seed=3 * n + bw)
    j = [jnp.asarray(a) for a in (acc, old, new)]
    got = ops.fused_accum_commit_stream(*(as_words(a) for a in (acc, old,
                                                                 new)))
    check_outputs(got, commit_fused.fused_accum_commit_stream(
        *j, chunk_blocks=4, interpret=True),
        ref.fused_accum_commit_stream_ref(*j))


def test_zone_stacked_accum_equals_per_rank_calls():
    """(2, 3, n, bw) in one call == six reference calls; each rank's digest
    covers its own pages only; the flat call's terms are the streamed
    call's."""
    acc, old, new = _accum_inputs((2, 3, 5, 64), seed=11)
    flat = ops.fused_accum_commit(*(as_words(a) for a in (acc, old, new)))
    streamed = ops.fused_accum_commit_stream(
        *(as_words(a) for a in (acc, old, new)))
    for a, b in zip(flat, streamed[:3]):
        assert torch.equal(a, b)
    for i in range(2):
        for k in range(3):
            want = ref.fused_accum_commit_stream_ref(
                *(jnp.asarray(a[i, k]) for a in (acc, old, new)))
            check_outputs([x[i, k] for x in streamed], want)


@pytest.mark.parametrize("shape", [(1001,), (7,), (3, 1024), (2, 5, 64),
                                   (4096,)])
def test_xor_delta_and_accum_plain_vs_pallas_and_ref(shape):
    """Any shape: 1-D of odd length, pages, zone-stacked pages (the Pallas
    kernel takes 1-D or 2-D words: it sees those as (-1, 64))."""
    a, b = rand_u32(shape, 21), rand_u32(shape, 22)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pa, pb = (ja, jb) if len(shape) < 3 else (ja.reshape(-1, shape[-1]),
                                              jb.reshape(-1, shape[-1]))
    for port_fn, pallas_fn, ref_fn in (
            (ops.xor_delta, xor_parity.xor_delta, ref.xor_delta_ref),
            (ops.xor_accum, xor_parity.xor_accum, ref.xor_accum_ref)):
        check_outputs([port_fn(as_words(a), as_words(b))],
                      [pallas_fn(pa, pb, interpret=True).reshape(shape)],
                      [ref_fn(ja, jb)])


def test_epoch_wrappers_refuse_what_they_cannot_launch():
    """Shapes and dtypes are checked on every path; the CUDA wrappers also
    refuse a non-contiguous operand and a CPU tensor, before any build or
    launch; a meta tensor gets the outputs' shapes; no other device has a
    kernel."""
    x = torch.zeros(2, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="one shape"):
        ops.xor_delta(x, torch.zeros(2, 32, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        ops.xor_accum(x, torch.zeros(2, 64, dtype=torch.int64))
    with pytest.raises(ValueError, match="must match"):
        ops.fused_accum_commit(torch.zeros(3, 64, dtype=torch.int32), x, x)
    with pytest.raises(ValueError, match="contiguous"):
        port_xor.xor_words_cuda(x.t(), x.t(), name="xor_delta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_xor.xor_words_cuda(x, x, name="xor_delta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_cf.commit_pages_cuda(x, x, digest=False,
                                  name="fused_accum_commit", acc=x)
    # meta (the dry run): the kernel's checks and its outputs' shapes
    meta = torch.zeros(2, 64, dtype=torch.int32, device="meta")
    out = ops.xor_delta(meta, meta)
    assert out.is_meta and out.shape == (2, 64)
    acc, old_t, new_t, dig = ops.fused_accum_commit_stream(meta, meta, meta)
    assert acc.shape == (2, 64) and old_t.shape == new_t.shape == (2, 2)
    assert dig.shape == (2,) and all(t.is_meta for t in (acc, old_t, dig))
    with pytest.raises(ValueError, match="one shape"):
        ops.xor_delta(meta, torch.zeros(2, 32, dtype=torch.int32,
                                        device="meta"))
    with pytest.raises(ValueError, match="no protection kernel"):
        ops._on_card(types.SimpleNamespace(device=torch.device("xpu")))
    assert "xor_parity" in _build.SOURCES
    assert len(ops.ENTRY_POINTS) == len(set(ops.ENTRY_POINTS)) == 19
