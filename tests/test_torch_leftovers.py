"""The last surfaces of ported modules against the reference's, on the
same inputs and the way the reference's own tests call them:
`gf.pow_g_array` and `gf.solve_two` (tests/test_gf.py), `utils`'
`words_per_elem`, `tree_bytes`, `tree_equal_bits` (tests/test_utils.py)
and `fingerprint`, and the `Protector`'s program factories `make_scrub`,
`make_local_scrub` (tests/test_pool.py), `make_recover_rank`,
`make_recover_e` and `make_repair_pages`.

Every result is byte-equal to the reference's.  `fingerprint` hashes
strings, so its value differs from one process and one package to the
next: it is held by its property (equal for equal key paths, shapes and
dtypes, different when any of them differs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import utils as ref_utils
from repro.core import gf as ref_gf
from repro.runtime import failure as ref_failure
from repro_torch import utils
from repro_torch.core import gf
from repro_torch.runtime import failure
from tests._torch_ref import (Pair, as_words, assert_prot_same,  # noqa: F401
                              one_thread, rand_u32, state_like, words)
from tests.test_torch_multi_loss import _verdicts

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("g", [1, 8, 100])
def test_pow_g_array(g):
    got, want = gf.pow_g_array(g), ref_gf.pow_g_array(g)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ra,rb", [(0, 1), (1, 3), (2, 7), (0, 63),
                                   (7, 2)])
def test_solve_two(ra, rb):
    """The e = 2 solve on tests/test_gf.py's P and Q of two seeded rows:
    the reference's two rows, which are the lost ones."""
    a, b = rand_u32(512, 2), rand_u32(512, 3)
    p = a ^ b
    q = (np.asarray(ref_gf.mul_pow_g(jnp.asarray(a), ra))
         ^ np.asarray(ref_gf.mul_pow_g(jnp.asarray(b), rb)))
    want = ref_gf.solve_two(jnp.asarray(p), jnp.asarray(q), ra, rb)
    got = gf.solve_two(as_words(p), as_words(q), ra, rb)
    for g_, w, lost in zip(got, want, (a, b)):
        np.testing.assert_array_equal(words(g_), np.asarray(w))
        np.testing.assert_array_equal(words(g_), lost)
    with pytest.raises(ValueError):
        gf.solve_two(as_words(p), as_words(q), ra, ra)


DTYPES = [("float32", torch.float32), ("bfloat16", torch.bfloat16),
          ("float16", torch.float16), ("int32", torch.int32),
          ("uint32", torch.uint32), ("int16", torch.int16),
          ("uint16", torch.uint16), ("int8", torch.int8),
          ("uint8", torch.uint8)]


@pytest.mark.parametrize("name,dtype", DTYPES)
def test_words_per_elem(name, dtype):
    assert utils.words_per_elem(dtype) == ref_utils.words_per_elem(
        jnp.dtype(name))


def test_words_per_elem_refuses_a_wide_dtype():
    with pytest.raises(ValueError):
        utils.words_per_elem(torch.float64)
    with pytest.raises(ValueError):
        ref_utils.words_per_elem(jnp.float64)


def test_tree_bytes():
    """tests/test_utils.py's tree, and the same as device="meta" tensors
    (a cold pool's abstract state) and numpy arrays."""
    ref = {"a": jnp.zeros((4, 4), jnp.float32), "b": jnp.zeros((2,),
                                                                jnp.bfloat16),
           "c": [jnp.zeros((3, 5), jnp.int8)]}
    port = {"a": torch.zeros((4, 4)), "b": torch.zeros(2,
                                                       dtype=torch.bfloat16),
            "c": [torch.zeros((3, 5), dtype=torch.int8)]}
    want = ref_utils.tree_bytes(ref)
    assert want == 64 + 4 + 15
    assert utils.tree_bytes(port) == want
    assert utils.tree_bytes(utils.abstract(port)) == want
    assert utils.tree_bytes(jax.tree.map(np.asarray, ref)) == want
    assert utils.tree_bytes({}) == ref_utils.tree_bytes({}) == 0


def _cases():
    """(name, a, b) pairs of trees, as numpy, for tree_equal_bits: the
    reference test's cases, and a dtype, a NaN payload, a structure and a
    leaf count that differ."""
    nan2 = np.array([1.0, np.nan], np.float32)
    other_nan = nan2.copy()
    other_nan.view(np.uint32)[1] ^= 1
    return [
        ("equal_nan", {"x": nan2}, {"x": nan2.copy()}),
        ("values", {"x": nan2}, {"x": np.array([1.0, 2.0], np.float32)}),
        ("shape", {"x": nan2}, {"x": np.zeros(3, np.float32)}),
        ("dtype", {"x": np.zeros(2, np.float32)},
         {"x": np.zeros(2, np.int32)}),
        ("nan_payload", {"x": nan2}, {"x": other_nan}),
        ("leaf_count", {"x": nan2}, {"x": nan2, "y": nan2}),
        ("nested_equal", {"a": [nan2, np.arange(3, dtype=np.int8)]},
         {"a": [nan2.copy(), np.arange(3, dtype=np.int8)]}),
    ]


@pytest.mark.parametrize("case", range(len(_cases())))
def test_tree_equal_bits(case):
    """The port's verdict on torch tensors (CPU) is the reference's on
    jax arrays of the same bits."""
    name, a, b = _cases()[case]
    want = ref_utils.tree_equal_bits(jax.tree.map(jnp.asarray, a),
                                     jax.tree.map(jnp.asarray, b))
    got = utils.tree_equal_bits(utils.tree_map(torch.from_numpy, a),
                                utils.tree_map(torch.from_numpy, b))
    assert got == want, name


def test_tree_equal_bits_on_bf16():
    x = torch.tensor([1.0, -0.0, 3.5], dtype=torch.bfloat16)
    y = x.clone()
    assert utils.tree_equal_bits({"w": x}, {"w": y})
    y.view(torch.int16)[1] ^= 1
    assert not utils.tree_equal_bits({"w": x}, {"w": y})
    assert not utils.tree_equal_bits({"w": x}, {"w": x.float()})


def test_fingerprint_property():
    """Equal for trees of the same key paths, shapes and dtypes (values
    and devices aside); different when a key, a shape, a dtype or the
    nesting differs — the reference's fingerprint agrees on each pair."""
    base = {"a": np.zeros((2, 3), np.float32),
            "b": [np.zeros(4, np.int32), np.zeros((1,), np.float32)]}
    same = {"b": [np.ones(4, np.int32), np.full((1,), 7, np.float32)],
            "a": np.ones((2, 3), np.float32)}
    differ = [
        {"a2": base["a"], "b": base["b"]},
        {"a": np.zeros((3, 2), np.float32), "b": base["b"]},
        {"a": np.zeros((2, 3), np.float16), "b": base["b"]},
        {"a": base["a"], "b": (base["b"][0], base["b"][1])[:1]},
        {"a": base["a"], "b": {"0": base["b"][0], "1": base["b"][1]}},
    ]

    def port(t):
        return utils.tree_map(torch.from_numpy, t)

    def ref(t):
        return jax.tree.map(jnp.asarray, t)

    assert utils.fingerprint(port(base)) == utils.fingerprint(port(same))
    assert utils.fingerprint(port(base)) == utils.fingerprint(
        utils.abstract(port(same)))
    assert ref_utils.fingerprint(ref(base)) == ref_utils.fingerprint(
        ref(same))
    for d in differ:
        assert utils.fingerprint(port(d)) != utils.fingerprint(port(base))
        assert ref_utils.fingerprint(ref(d)) != ref_utils.fingerprint(
            ref(base))


@pytest.mark.parametrize("mesh_name,r", [("mesh42", 3), ("mesh81", 1)])
def test_scrub_factories(mesh_name, r):
    """`make_scrub()` and `make_local_scrub()` give the reference's
    programs' verdicts, clean and after a scribble (tests/test_pool.py
    calls both)."""
    pr = Pair(mesh_name, "mlpc", redundancy=r)
    pr.commit(state_like(1, pr.cur), seed=1)
    for rp, pp in ((pr.rp, pr.pp), (
            ref_failure.inject_scribble(pr.ref, pr.rp, 1, [3, 100])[0],
            failure.inject_scribble(pr.port, pr.pp, 1, [3, 100])[0])):
        want = _verdicts(jax.jit(pr.ref.make_scrub())(rp))
        assert _verdicts(pr.port.make_scrub()(pp)) == want
        want = _verdicts(jax.jit(pr.ref.make_local_scrub())(rp))
        assert _verdicts(pr.port.make_local_scrub()(pp)) == want


def test_recovery_factories():
    """`make_recover_rank`, `make_recover_e` and `make_repair_pages` at
    r = 3 give the reference's recovered states, byte for byte; an
    erasure set of repeated ranks or past the budget is refused when the
    program is made."""
    pr = Pair("mesh42", "mlpc", redundancy=3)
    pr.commit(state_like(1, pr.cur), seed=1)
    rp, _ = ref_failure.inject_rank_loss(pr.ref, pr.rp, 2)
    pp, _ = failure.inject_rank_loss(pr.port, pr.pp, 2)
    (rp2, rok), (pp2, pok) = (jax.jit(pr.ref.make_recover_rank())(rp, 2),
                              pr.port.make_recover_rank()(pp, 2))
    assert bool(rok) and bool(pok)
    assert_prot_same(rp2, pr.mesh, pp2)
    assert_prot_same(pr.rp, pr.mesh, pp2)

    rp, _ = ref_failure.inject_multi_rank_loss(pr.ref, pr.rp, (0, 1, 3))
    pp, _ = failure.inject_multi_rank_loss(pr.port, pr.pp, (0, 1, 3))
    (rp2, rok), (pp2, pok) = (jax.jit(pr.ref.make_recover_e((3, 0, 1)))(rp),
                              pr.port.make_recover_e((3, 0, 1))(pp))
    assert bool(rok) and bool(pok)
    assert_prot_same(rp2, pr.mesh, pp2)
    with pytest.raises(ValueError, match="distinct"):
        pr.port.make_recover_e((1, 1))
    with pytest.raises(RuntimeError, match="syndrome budget exhausted"):
        pr.port.make_recover_e((0, 1, 2, 3))
    with pytest.raises(RuntimeError, match="syndrome budget exhausted"):
        pr.ref.make_recover_e((0, 1, 2, 3))

    rp, _ = ref_failure.inject_scribble(pr.ref, pr.rp, 1, [3, 100])
    pp, _ = failure.inject_scribble(pr.port, pr.pp, 1, [3, 100])
    (rp2, rok), (pp2, pok) = (
        jax.jit(pr.ref.make_repair_pages(2))(rp, [1, 1], [0, 1]),
        pr.port.make_repair_pages(2)(pp, [1, 1], [0, 1]))
    assert bool(rok) and bool(pok)
    assert_prot_same(rp2, pr.mesh, pp2)
    assert_prot_same(pr.rp, pr.mesh, pp2)
