"""repro_torch.core.checksum against repro.core.checksum: every function
byte-equal on the same seeded inputs (u32 words, so no tolerance)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import checksum as ref_ck
from repro_torch.core import checksum as ck
from tests._torch_ref import as_words, rand_u32, words
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("nb,bw", [(1, 64), (5, 64), (13, 1024)])
def test_block_checksums_combine_digest(nb, bw):
    row = rand_u32((nb * bw,), seed=nb)
    t = as_words(row)
    np.testing.assert_array_equal(
        words(ck.block_checksums(t, bw)),
        np.asarray(ref_ck.block_checksums(jnp.asarray(row), bw)))
    cks = rand_u32((nb, 2), seed=nb + 1)
    np.testing.assert_array_equal(
        words(ck.combine(as_words(cks), bw)),
        np.asarray(ref_ck.combine(jnp.asarray(cks), bw)))
    np.testing.assert_array_equal(
        words(ck.digest(t, bw)), np.asarray(ref_ck.digest(jnp.asarray(row),
                                                          bw)))


def test_combine_with_leading_dims():
    cks = rand_u32((4, 2, 7, 2), seed=3)
    got = words(ck.combine(as_words(cks), 64))
    for i in range(4):
        for j in range(2):
            np.testing.assert_array_equal(
                got[i, j], np.asarray(ref_ck.combine(jnp.asarray(cks[i, j]),
                                                     64)))


def test_verify_blocks_flags_exactly_the_bad_blocks():
    row = rand_u32((6 * 64,), seed=4)
    stored = np.asarray(ref_ck.block_checksums(jnp.asarray(row), 64)).copy()
    stored[2, 1] ^= 1
    stored[5, 0] ^= 0x80000000
    got = ck.verify_blocks(as_words(row), as_words(stored), 64)
    want = np.asarray(ref_ck.verify_blocks(jnp.asarray(row),
                                           jnp.asarray(stored), 64))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.tolist() == [False, False, True, False, False, True]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_digest(seed):
    nb, bw = 9, 64
    idx = np.array([0, 3, 8], np.int32)
    dig, old_ck, new_ck = (rand_u32((2,), seed), rand_u32((3, 2), seed + 10),
                           rand_u32((3, 2), seed + 20))
    got = ck.update_digest(as_words(dig), as_words(old_ck), as_words(new_ck),
                           torch.from_numpy(idx), nb, bw)
    want = ref_ck.update_digest(jnp.asarray(dig), jnp.asarray(old_ck),
                                jnp.asarray(new_ck), jnp.asarray(idx), nb, bw)
    np.testing.assert_array_equal(words(got), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_update_digest_words(seed):
    row_words = 4096
    offs = np.sort(np.random.default_rng(seed).choice(
        row_words, 17, replace=False)).astype(np.int32)
    dig, old_w, new_w = (rand_u32((2,), seed), rand_u32((17,), seed + 1),
                         rand_u32((17,), seed + 2))
    got = ck.update_digest_words(as_words(dig), as_words(old_w),
                                 as_words(new_w), torch.from_numpy(offs),
                                 row_words)
    want = ref_ck.update_digest_words(jnp.asarray(dig), jnp.asarray(old_w),
                                      jnp.asarray(new_w), jnp.asarray(offs),
                                      row_words)
    np.testing.assert_array_equal(words(got), np.asarray(want))


@pytest.mark.parametrize("start,length", [(0, 64), (5, 11), (63, 1)])
def test_update_range(start, length):
    block = rand_u32((64,), seed=start)
    cks = np.asarray(ref_ck.block_checksums(jnp.asarray(block), 64))[0]
    new = rand_u32((length,), seed=start + 1)
    old = block[start:start + length]
    got = ck.update_range(as_words(cks), as_words(old), as_words(new),
                          start, 64)
    want = ref_ck.update_range(jnp.asarray(cks), jnp.asarray(old),
                               jnp.asarray(new), start, 64)
    np.testing.assert_array_equal(words(got), np.asarray(want))
    # and the update equals a recompute of the modified block
    block2 = block.copy()
    block2[start:start + length] = new
    np.testing.assert_array_equal(
        words(got), words(ck.block_checksums(as_words(block2), 64)[0]))


def test_set_and_update_blocks():
    cks = rand_u32((6, 2), seed=7)
    new_blocks = rand_u32((2, 64), seed=8)
    idx = np.array([1, 4], np.int32)
    got = ck.update_blocks(as_words(cks), as_words(new_blocks),
                           torch.from_numpy(idx), 64)
    want = ref_ck.update_blocks(jnp.asarray(cks), jnp.asarray(new_blocks),
                                jnp.asarray(idx), 64)
    np.testing.assert_array_equal(words(got), np.asarray(want))
