"""Dispatch for the protection kernels (the r = 1 routes of the reference's
kernels/ops.py).

A CUDA tensor launches the hand-written Hopper kernel, and anything the
kernel cannot take raises — there is no fallback.  A CPU tensor takes the
kernel's plain PyTorch version (the tests run here).  Any other device
raises.

Pages come as `(*lead, n, bw)` int32 words; each leading index is one
rank of the zone-stacked state, and one launch covers all of them (every
kernel is per-page independent; only the digest is per rank).  The six
entry points and the kernel behind each:

    fletcher_blocks             fletcher_pages<DIGEST=false>
    fletcher_stream             fletcher_pages<DIGEST=true>
    fused_commit                commit_pages<VERIFY=false, DIGEST=false>
    fused_verify_commit         commit_pages<VERIFY=true,  DIGEST=false>
    fused_commit_old_terms      commit_pages<VERIFY=true,  DIGEST=false>,
                                stored = 0
    fused_verify_commit_stream  commit_pages<VERIFY=true,  DIGEST=true>
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import commit_fused as _cf
from repro_torch.kernels import fletcher as _fl

ENTRY_POINTS = ("fletcher_blocks", "fletcher_stream", "fused_commit",
                "fused_verify_commit", "fused_commit_old_terms",
                "fused_verify_commit_stream")


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no protection kernel for device {x.device}")


def fletcher_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """`(*lead, n, bw)` -> `(*lead, n, 2)` per-page terms."""
    if _on_card(blocks):
        return _fl.fletcher_pages_cuda(blocks, digest=False,
                                       name="fletcher_blocks")[0]
    return _fl.fletcher_pages_plain(blocks)


def fletcher_stream(blocks: torch.Tensor, *, chunk_blocks: int = 8) -> tuple:
    """(terms, per-rank `(*lead, 2)` row digest).  `chunk_blocks` sized the
    reference's VMEM chunks and changes nothing here."""
    if _on_card(blocks):
        return _fl.fletcher_pages_cuda(blocks, digest=True,
                                       name="fletcher_stream")
    return _fl.fletcher_stream_plain(blocks)


def fused_commit(old: torch.Tensor, new: torch.Tensor) -> tuple:
    """(delta, new terms)."""
    if _on_card(new):
        out = _cf.commit_pages_cuda(old, new, digest=False,
                                    name="fused_commit")
    else:
        out = _cf.commit_pages_plain(old, new)
    return out[0], out[1]


def fused_verify_commit(old: torch.Tensor, new: torch.Tensor,
                        stored: torch.Tensor) -> tuple:
    """(delta, new terms, bad) — bad `(*lead, n)` marks old pages whose
    terms no longer match `stored` (verify-at-micro-buffer-open)."""
    if _on_card(new):
        delta, ck, mism, _ = _cf.commit_pages_cuda(
            old, new, stored, digest=False, name="fused_verify_commit")
    else:
        delta, ck, mism, _ = _cf.commit_pages_plain(old, new, stored)
    return delta, ck, (mism != 0).any(dim=-1)


def fused_commit_old_terms(old: torch.Tensor, new: torch.Tensor) -> tuple:
    """(delta, new terms, old terms): the verify sweep with stored = 0."""
    zeros = torch.zeros(*new.shape[:-1], 2, dtype=torch.int32,
                        device=new.device)
    if _on_card(new):
        out = _cf.commit_pages_cuda(old, new, zeros, digest=False,
                                    name="fused_commit_old_terms")
    else:
        out = _cf.commit_pages_plain(old, new, zeros)
    return out[0], out[1], out[2]


def fused_verify_commit_stream(old: torch.Tensor, new: torch.Tensor,
                               stored: torch.Tensor, *,
                               chunk_blocks: int = 8) -> tuple:
    """(delta, new terms, bad, per-rank row digest of the new pages)."""
    if _on_card(new):
        delta, ck, mism, dig = _cf.commit_pages_cuda(
            old, new, stored, digest=True, name="fused_verify_commit_stream")
    else:
        delta, ck, mism, dig = _cf.commit_pages_plain(old, new, stored,
                                                      digest=True)
    return delta, ck, (mism != 0).any(dim=-1), dig


def stream_chunk_blocks(n_blocks: int, block_words: int, *,
                        threshold_words: int,
                        chunk_words: int) -> Optional[int]:
    """The engines' flat-vs-streamed policy, as in the reference: the
    streamed chunk height, or None when the row stays on the flat kernels.
    On the card both routes run the same kernel (the streamed one adds the
    digest); the launch counters show which route a commit took."""
    if threshold_words <= 0 or n_blocks * block_words < threshold_words:
        return None
    return max(1, min(int(chunk_words) // int(block_words), n_blocks))
