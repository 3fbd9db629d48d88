"""GF(2^32) arithmetic of the port against the reference's, and the plain
versions of the two weighting kernels (`gf_scale`, `sdelta_stack`) against
the reference's Pallas kernels run in interpret mode AND its kernels/ref.py
oracles, byte for byte.

Host layer: the syndrome tables, the Vandermonde inverses and the solve.
Tensor layer: xtime / mul_const / mul_pow_g on int32 words with bit 31 set
(the arithmetic-shift trap) and coefficients 0, 1, POLY and 0xFFFFFFFF.
The fused syndrome sweeps are in test_torch_gf_kernels.py; the CUDA
kernels are held against these plain versions on the card
(test_torch_cuda.py, chip_smoke.py)."""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gf as ref_gf
from repro.kernels import gf_parity as ref_gp
from repro.kernels import ref
from repro_torch.core import gf
from repro_torch.dist.sharding import ZoneMesh
from repro_torch.kernels import ops
from tests._torch_ref import GF_SHAPES, as_words, rand_u32, words
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SPECIAL = (0, 1, gf.POLY, 0xFFFFFFFF, 0x80000000, 0x80000001)


def test_constants_and_host_products_match_reference():
    assert (gf.POLY, gf.ORDER, gf.MASK) == (ref_gf.POLY, ref_gf.ORDER,
                                            ref_gf.MASK)
    rng = random.Random(0)
    vals = list(SPECIAL) + [rng.getrandbits(32) for _ in range(40)]
    for a in vals:
        assert gf.xtime_int(a) == ref_gf.xtime_int(a)
        for b in vals[:12]:
            assert gf.mul_int(a, b) == ref_gf.mul_int(a, b)
        assert gf.pow_int(a, 12345) == ref_gf.pow_int(a, 12345)
        if a:
            assert gf.inv_int(a) == ref_gf.inv_int(a)
    for k in (0, 1, 31, 32, 99, 297, 5000):
        assert gf.pow_g_int(k) == ref_gf.pow_g_int(k)
    with pytest.raises(ZeroDivisionError):
        gf.inv_int(0)


@pytest.mark.parametrize("g", [2, 4, 8, 33, 100])
def test_syndrome_tables_match_reference(g):
    assert gf.pow_g_table(g) == ref_gf.pow_g_table(g)
    for r in range(1, 5):
        assert gf.syndrome_table(g, r) == ref_gf.syndrome_table(g, r)
        np.testing.assert_array_equal(gf.syndrome_array(g, r),
                                      ref_gf.syndrome_array(g, r))


@pytest.mark.parametrize("g", [4, 8, 100])
def test_vandermonde_inverse_and_solve_match_reference(g):
    rng = np.random.default_rng(g)
    sets = [(0,), (g - 1,), (0, g - 1), (g - 2, g - 1)]
    sets += [tuple(sorted(int(a) for a in rng.choice(g, size=e,
                                                     replace=False)))
             for e in (2, 3, min(4, g - 1)) for _ in range(3)]
    for ranks in sets:
        assert gf.vandermonde_int(ranks) == ref_gf.vandermonde_int(ranks)
        assert gf.inv_vandermonde_int(ranks) == \
            ref_gf.inv_vandermonde_int(ranks)
        deficits = [int(v) for v in rng.integers(0, 2**32, len(ranks))]
        assert gf.solve_e_int(deficits, ranks) == \
            ref_gf.solve_e_int(deficits, ranks)
    assert gf.solve_two_int(5, 7, 0, g - 1) == \
        ref_gf.solve_two_int(5, 7, 0, g - 1)
    with pytest.raises(ValueError, match="distinct"):
        gf.inv_vandermonde_int((1, 1))


def test_tensor_layer_matches_reference():
    x = rand_u32((4, 64), seed=1)
    x[0, :8] = [0, 1, 0x80000000, 0xFFFFFFFF, gf.POLY, 0x7FFFFFFF,
                0xC0000000, 0x80000001]
    jx, tx = jnp.asarray(x), as_words(x)
    np.testing.assert_array_equal(words(gf.xtime(tx)),
                                  np.asarray(ref_gf.xtime(jx)))
    rng = random.Random(2)
    for c in list(SPECIAL) + [rng.getrandbits(32) for _ in range(6)]:
        want = np.asarray(ref_gf.mul_const(jx, c))
        np.testing.assert_array_equal(words(gf.mul_const(tx, c)), want)
        # the coefficient as an int32 tensor (bit 31 is the sign bit)
        tc = as_words(np.asarray([c], np.uint32))
        np.testing.assert_array_equal(words(gf.mul_const(tx, tc)), want)
        for w in (0, 2, 3):                       # lane by lane, host ints
            assert int(want[0, w]) == ref_gf.mul_int(int(x[0, w]), c)
    for k in (0, 1, 5, 31, 32, 77):
        np.testing.assert_array_equal(words(gf.mul_pow_g(tx, k)),
                                      np.asarray(ref_gf.mul_pow_g(jx, k)))
    # per-row coefficients broadcast like the zone's per-rank table
    coeffs = rand_u32((4, 1), seed=3)
    got = words(gf.mul_const(tx, as_words(coeffs)))
    for i in range(4):
        np.testing.assert_array_equal(
            got[i], np.asarray(ref_gf.mul_const(jx[i], int(coeffs[i, 0]))))


@pytest.mark.parametrize("shape,axes", [((4, 2), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model")),
                                        ((100, 1), ("data", "model"))])
def test_rank_syndrome_coeffs_are_each_devices_table_row(shape, axes):
    mesh = ZoneMesh(shape, axes)
    g = mesh.axis_size("data")
    for r in (2, 3, 4):
        if r > g - 1 and g > 2:
            continue
        table = gf.rank_syndrome_coeffs(g, r, mesh, "cpu")
        assert table.shape == (*shape, r) and table.is_contiguous()
        host = ref_gf.syndrome_array(g, r)
        for idx in np.ndindex(*shape):
            np.testing.assert_array_equal(words(table[idx]),
                                          host[idx[mesh.data_dim]])


def _coeffs(r, rank=99, g=100):
    """A rank's coefficient row (g^(k·rank)); rank 99 of 100 gives large
    coefficients with high bits set."""
    return ref_gf.syndrome_array(g, r)[rank]


@pytest.mark.parametrize("shape", GF_SHAPES)
@pytest.mark.parametrize("r", [2, 3, 4])
def test_weighting_plain_vs_pallas_and_ref(r, shape):
    x = rand_u32(shape, seed=r * 100 + shape[0])
    co = _coeffs(r)
    jx, jc = jnp.asarray(x), jnp.asarray(co)
    tx = as_words(x)
    # sdelta_stack: one rank's flat row -> (r, m)
    got = words(ops.syndrome_scale(tx.reshape(-1), as_words(co)))
    np.testing.assert_array_equal(
        got, np.asarray(ref_gp.sdelta_stack(jx.reshape(-1), jc,
                                            interpret=True)))
    np.testing.assert_array_equal(
        got, np.asarray(ref.sdelta_stack_ref(jx.reshape(-1), jc)))
    np.testing.assert_array_equal(got[0], x.reshape(-1))
    # gf_scale by the rank's last coefficient and by 0xFFFFFFFF
    for c in (int(co[-1]), 0xFFFFFFFF):
        got = words(ops.gf_scale(tx, c))
        np.testing.assert_array_equal(
            got, np.asarray(ref_gp.gf_scale(jx, jnp.uint32(c),
                                            interpret=True)))
        np.testing.assert_array_equal(got,
                                      np.asarray(ref.gf_scale_ref(jx, c)))


def test_zone_stacked_weighting_equals_per_rank_calls():
    """`(L, m)` words with each rank's own coefficient row in one call ==
    one reference call per rank; syndrome_scale at r = 1 is the words."""
    g, r, m = 6, 3, 128
    x = rand_u32((g, 1, m), seed=9)
    table = gf.rank_syndrome_coeffs(g, r, ZoneMesh((g, 1), ("data", "m")),
                                    "cpu")
    got = words(ops.syndrome_scale(as_words(x), table))
    assert got.shape == (g, 1, r, m)
    for i in range(g):
        np.testing.assert_array_equal(
            got[i, 0], np.asarray(ref.sdelta_stack_ref(
                jnp.asarray(x[i, 0]), jnp.asarray(_coeffs(r, i, g)))))
    t = as_words(x)
    one = ops.syndrome_scale(t, None)
    assert one.shape == (g, 1, 1, m) and torch.equal(one[..., 0, :], t)
