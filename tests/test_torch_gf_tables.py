"""The table multiply of the `weight_words` kernel (csrc/gf.cuh), in its
plain PyTorch form (`gf_parity.table_build_plain` / `table_mul_plain`, the
same eight 4-bit chunks a word), against the port's 32-step
`gf.mul_const` and the reference's `gf_scale` / `sdelta_stack` — its Pallas
kernels in interpret mode AND its kernels/ref.py oracles — byte for byte.

Coefficients: 0, 1, g, g^31, 0x80000000, 0xFFFFFFFF, every rank
coefficient of a zone of 100 at r = 2..4 and 64 random ones; words with 0,
1, 0xFFFFFFFF and bit 31 set among random ones.  The CUDA kernel is held
against the plain `gf_scale` / `sdelta_stack` on the card
(test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gf as ref_gf
from repro.kernels import gf_parity as ref_gp
from repro.kernels import ref
from repro_torch.core import gf
from repro_torch.kernels import gf_parity as gfk
from tests._torch_ref import as_words, rand_u32, words
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NAMED = {"zero": 0, "one": 1, "g": 2, "g^31": ref_gf.pow_g_int(31),
         "bit31": 0x80000000, "all_ones": 0xFFFFFFFF}


def _words(shape, seed):
    """Random u32 words whose first row starts with the edge values."""
    x = rand_u32(shape, seed)
    x.reshape(-1)[:6] = [0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, gf.POLY]
    return x


def _stack(x, coeffs):
    """sdelta_stack by the table multiply: plane 0 raw, plane k by the
    tables of coeffs[..., k]."""
    return torch.stack([x] + [
        gfk.table_mul_plain(x, gfk.table_build_plain(coeffs[..., k]))
        for k in range(1, coeffs.shape[-1])], dim=-2)


@pytest.mark.parametrize("name", sorted(NAMED))
def test_table_entries_are_the_products(name):
    """Entry [j, v] of a coefficient's tables is c·(v << 4j) as the
    reference's host arithmetic computes it."""
    c = NAMED[name]
    table = words(gfk.table_build_plain(c))
    assert table.shape == (gfk.CHUNKS, 16)
    for j in range(gfk.CHUNKS):
        for v in range(16):
            assert int(table[j, v]) == ref_gf.mul_int(v << (4 * j), c)


@pytest.mark.parametrize("name", sorted(NAMED))
def test_table_mul_matches_mul_const_and_reference(name):
    c = NAMED[name]
    x = _words((16, 256), seed=7)
    jx, tx = jnp.asarray(x), as_words(x)
    got = gfk.table_mul_plain(tx, gfk.table_build_plain(c))
    assert torch.equal(got, gf.mul_const(tx, c))
    np.testing.assert_array_equal(
        words(got), np.asarray(ref_gp.gf_scale(jx, jnp.uint32(c),
                                               interpret=True)))
    np.testing.assert_array_equal(words(got),
                                  np.asarray(ref.gf_scale_ref(jx, c)))


def test_table_mul_random_coefficients():
    """64 random coefficients (numpy seed), each on its own and as a
    tensor of per-row coefficients."""
    coeffs = rand_u32((64,), seed=11)
    x = _words((64, 128), seed=12)
    jx, tx = jnp.asarray(x), as_words(x)
    for i, c in enumerate(coeffs.tolist()):
        got = gfk.table_mul_plain(tx[i], gfk.table_build_plain(c))
        want = np.asarray(ref_gp.gf_scale(jx[i], jnp.uint32(c),
                                          interpret=True))
        np.testing.assert_array_equal(words(got), want)
        np.testing.assert_array_equal(
            want, np.asarray(ref.gf_scale_ref(jx[i], c)))
    # one table per row, as weight_words holds one per rank
    tables = gfk.table_build_plain(as_words(coeffs))
    assert tables.shape == (64, gfk.CHUNKS, 16)
    per_row = gfk.table_mul_plain(tx, tables)
    assert torch.equal(per_row, gf.mul_const(tx, as_words(coeffs)[:, None]))


@pytest.mark.parametrize("r", [2, 3, 4])
def test_rank_coefficients_stack_matches_sdelta_stack(r):
    """Every rank of a zone of 100: the table-multiply stack equals the
    port's plain sdelta_stack, and the reference's sdelta_stack (Pallas
    interpret and ref.py) rank by rank."""
    g, m = 100, 64
    table = ref_gf.syndrome_array(g, r)
    x = _words((g, m), seed=r)
    tx, tc = as_words(x), as_words(table)
    got = _stack(tx, tc)
    assert torch.equal(got, gfk.sdelta_stack_plain(tx, tc))
    got = words(got)
    for i in range(g):
        jx, jc = jnp.asarray(x[i]), jnp.asarray(table[i])
        np.testing.assert_array_equal(
            got[i], np.asarray(ref_gp.sdelta_stack(jx, jc, interpret=True)))
        np.testing.assert_array_equal(
            got[i], np.asarray(ref.sdelta_stack_ref(jx, jc)))
