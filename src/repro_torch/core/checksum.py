"""Fletcher-64 block checksums over u32 words (int32 bit patterns).

The reference's scheme (core/checksum.py), kept bit for bit:

    A(w) = sum_i w_i                      (mod 2^32)
    B(w) = sum_i (n - i) * w_i            (mod 2^32)

Combine for concat(x |n|, y |m|):   A = Ax + Ay,  B = Bx + m*Ax + By.
Range update w[s:e] old->new:       A += sum d,   B += sum (n-s-i) * d_i.

Every function takes leading batch dims — a zone-stacked row
`(*mesh_dims, n)` yields `(*mesh_dims, n_blocks, 2)` terms and a
`(*mesh_dims, 2)` digest.  Arithmetic that can exceed 32 bits runs in int64
on unsigned values and wraps back (`utils.wrap32`).
"""
from __future__ import annotations

import torch

from repro_torch.utils import as_u64, mul32, sum32, wrap32

# 4 KB pages = 1024 words: the paper's page-column unit.
DEFAULT_BLOCK_WORDS = 1024


def _stack(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return wrap32(torch.stack([a, b], dim=-1))


def block_checksums(row: torch.Tensor,
                    block_words: int = DEFAULT_BLOCK_WORDS) -> torch.Tensor:
    """Per-block (A, B) terms: `(*lead, n)` -> `(*lead, n // bw, 2)`.

    Dispatches to the Hopper Fletcher kernel for a CUDA row
    (kernels/ops.py); a CPU row takes its plain version.
    """
    if row.shape[-1] % block_words:
        raise ValueError(f"row of {row.shape[-1]} words is not a whole "
                         f"number of {block_words}-word blocks")
    from repro_torch.kernels import ops as kops
    return kops.fletcher_blocks(
        row.reshape(*row.shape[:-1], -1, block_words))


def combine(cksums: torch.Tensor,
            block_words: int = DEFAULT_BLOCK_WORDS) -> torch.Tensor:
    """Fold per-block terms `(*lead, nb, 2)` into one `(*lead, 2)` digest."""
    nb = cksums.shape[-2]
    a_blocks = as_u64(cksums[..., 0])
    b_blocks = as_u64(cksums[..., 1])
    # words after block i: (nb - 1 - i) * block_words
    after = ((nb - 1 - torch.arange(nb, device=cksums.device))
             * block_words) & 0xFFFFFFFF
    a = sum32(a_blocks, -1)
    b = sum32(b_blocks + mul32(after, a_blocks), -1)
    return _stack(a, b)


def verify_blocks(row: torch.Tensor, cksums: torch.Tensor,
                  block_words: int = DEFAULT_BLOCK_WORDS) -> torch.Tensor:
    """Recompute and compare; per-block mismatch mask (True = bad)."""
    fresh = block_checksums(row, block_words)
    return (fresh != cksums).any(dim=-1)


def set_blocks(cksums: torch.Tensor, fresh: torch.Tensor,
               block_idx: torch.Tensor) -> torch.Tensor:
    """Scatter precomputed `(*lead, k, 2)` terms into a copy of the table."""
    out = cksums.clone()
    out[..., block_idx, :] = fresh
    return out


def update_blocks(cksums: torch.Tensor, new_blocks: torch.Tensor,
                  block_idx: torch.Tensor,
                  block_words: int = DEFAULT_BLOCK_WORDS) -> torch.Tensor:
    """Recompute the terms of the given blocks only (cost ∝ dirty blocks)."""
    from repro_torch.kernels import ops as kops
    return set_blocks(cksums, kops.fletcher_blocks(new_blocks.contiguous()),
                      block_idx)


def update_range(cksum: torch.Tensor, old: torch.Tensor, new: torch.Tensor,
                 start: int, n_words: int) -> torch.Tensor:
    """Word-granular update within one block of `n_words` words.

    `cksum`: `(*lead, 2)`; `old`/`new`: `(*lead, m)` contents of the range
    starting at word `start` of the block.
    """
    d = (as_u64(new) - as_u64(old)) & 0xFFFFFFFF
    idx = start + torch.arange(d.shape[-1], device=d.device)
    w = (n_words - idx) & 0xFFFFFFFF
    da = sum32(d, -1)
    db = sum32(mul32(w, d), -1)
    return _stack(as_u64(cksum[..., 0]) + da, as_u64(cksum[..., 1]) + db)


def update_digest(dig: torch.Tensor, old_ck: torch.Tensor,
                  new_ck: torch.Tensor, block_idx: torch.Tensor,
                  n_blocks: int,
                  block_words: int = DEFAULT_BLOCK_WORDS) -> torch.Tensor:
    """Incremental row digest from the dirty blocks' term changes.

    `dig`: `(*lead, 2)`; `old_ck`/`new_ck`: `(*lead, k, 2)` terms of the
    dirty blocks before/after; `block_idx`: `(k,)` their positions.
    Bit-identical to a full `combine` (mod-2^32 arithmetic is exact).
    """
    da_blocks = (as_u64(new_ck[..., 0]) - as_u64(old_ck[..., 0])) & 0xFFFFFFFF
    db_blocks = (as_u64(new_ck[..., 1]) - as_u64(old_ck[..., 1])) & 0xFFFFFFFF
    after = ((n_blocks - 1 - block_idx.to(torch.int64)) * block_words
             ) & 0xFFFFFFFF
    da = sum32(da_blocks, -1)
    db = sum32(db_blocks + mul32(after, da_blocks), -1)
    return _stack(as_u64(dig[..., 0]) + da, as_u64(dig[..., 1]) + db)


def update_digest_words(dig: torch.Tensor, old_w: torch.Tensor,
                        new_w: torch.Tensor, row_offsets: torch.Tensor,
                        row_words: int) -> torch.Tensor:
    """Word-granular incremental row digest.

    The digest is linear in word position: A = sum_j w_j,
    B = sum_j (row_words - j) * w_j, so a commit that changes only the
    words at `row_offsets` shifts it by the word deltas alone.  Unmodified
    entries have delta zero and may repeat; modified words appear once.
    """
    d = (as_u64(new_w) - as_u64(old_w)) & 0xFFFFFFFF
    w = (row_words - row_offsets.to(torch.int64)) & 0xFFFFFFFF
    da = sum32(d, -1)
    db = sum32(mul32(w, d), -1)
    return _stack(as_u64(dig[..., 0]) + da, as_u64(dig[..., 1]) + db)


def digest(row: torch.Tensor,
           block_words: int = DEFAULT_BLOCK_WORDS) -> torch.Tensor:
    """(A, B) digest of a full row."""
    return combine(block_checksums(row, block_words), block_words)
