"""repro_torch.utils against repro.utils: the word view of every dtype the
reference supports, byte-equal, at even and odd lengths and with leading
zone dims; plus the int32-as-u32 arithmetic helpers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import utils as ref_utils
from repro_torch import convert, utils
from tests._torch_ref import words
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

DTYPES = ["float32", "int32", "uint32", "bfloat16", "float16", "int16",
          "uint16", "int8", "uint8"]


def _values(dtype, n, seed):
    bits = np.random.default_rng(seed).integers(
        0, 256, size=n * jnp.dtype(dtype).itemsize, dtype=np.uint8)
    return bits.view(jnp.dtype(dtype))


@pytest.mark.parametrize("n", [1, 3, 6, 7])
@pytest.mark.parametrize("dtype", DTYPES)
def test_word_view_matches_reference(dtype, n):
    x = _values(dtype, n, seed=n)
    want = np.asarray(ref_utils.to_words(jnp.asarray(x)))
    t = convert._leaf(x, "cpu")
    got = utils.to_words(t)
    np.testing.assert_array_equal(words(got), want)
    assert utils.num_words((n,), t.dtype) == ref_utils.num_words((n,), x.dtype)
    back = utils.from_words(got, (n,), t.dtype)
    assert back.dtype == t.dtype
    assert convert._np_leaf(back).tobytes() == x.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_word_view_with_leading_dims(dtype):
    """A zone-stacked (4, 2, 3, 5) leaf gives each device's own words."""
    x = _values(dtype, 4 * 2 * 15, seed=1).reshape(4, 2, 3, 5)
    t = convert._leaf(x, "cpu")
    got = utils.to_words(t, batch_dims=2)
    for i in range(4):
        for j in range(2):
            want = np.asarray(ref_utils.to_words(jnp.asarray(x[i, j])))
            np.testing.assert_array_equal(words(got[i, j]), want)
    back = utils.from_words(got, (3, 5), t.dtype)
    assert convert._np_leaf(back).tobytes() == x.tobytes()


def test_u32_arithmetic_helpers():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, size=64, dtype=np.uint64)
    b = rng.integers(0, 2**32, size=64, dtype=np.uint64)
    ta, tb = torch.from_numpy(a.astype(np.int64)), torch.from_numpy(
        b.astype(np.int64))
    want = (a * b) & 0xFFFFFFFF            # uint64 wraps mod 2^64
    np.testing.assert_array_equal(utils.mul32(ta, tb).numpy(), want)
    assert int(utils.sum32(ta)) == int(a.sum() & 0xFFFFFFFF)
    w = utils.wrap32(ta)
    np.testing.assert_array_equal(w.numpy().view(np.uint32),
                                  a.astype(np.uint32))
    np.testing.assert_array_equal(utils.as_u64(w).numpy(), a.astype(np.int64))
    assert utils.word(0xDEADBEEF) == np.uint32(0xDEADBEEF).view(np.int32)


def test_pad_round_up_and_trees():
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    assert utils.pad_to(x, 5).tolist() == [[0, 1, 2, 0, 0], [3, 4, 5, 0, 0]]
    assert utils.round_up(65, 64) == 128
    tree = {"b": [1, (2, 3)], "a": None, "c": 4}
    leaves, treedef = utils.tree_flatten(tree)
    assert leaves == [1, 2, 3, 4]              # dict keys sorted, as JAX does
    assert utils.tree_unflatten(treedef, leaves) == tree
    assert utils.tree_map(lambda v, w: v + w, tree, tree)["b"][1] == (4, 6)


def test_microbuffer_canaries_match_reference():
    from repro.core import microbuffer as ref_mb
    from repro_torch.core import microbuffer as mb
    row = np.arange(10, dtype=np.uint32)
    g = mb.guard(torch.from_numpy(row.view(np.int32)))
    np.testing.assert_array_equal(
        words(g), np.asarray(ref_mb.guard(jnp.asarray(row))))
    assert bool(mb.check(g))
    g[11] = 7
    assert not bool(mb.check(g))
    nd = mb.guard_nd(torch.zeros(3, 4, dtype=torch.int32))
    np.testing.assert_array_equal(
        words(nd), np.asarray(ref_mb.guard_nd(jnp.zeros((3, 4), jnp.uint32))))
    assert bool(mb.check_nd(nd)) and mb.interior_nd(nd).shape == (3, 4)
