"""Per-page Fletcher-64 terms: the Hopper kernel's wrapper and plain version.

The CUDA kernel `fletcher_pages<DIGEST>` (csrc/fletcher.cu) replaces the
Pallas kernels `fletcher_blocks` (src/repro/kernels/fletcher.py:38) and
`fletcher_stream` (:82).  It is bound by memory bytes: one read of every
word, with the term table 1/512 of that at bw = 1024.  A CTA takes a run
of `RUN_PAGES` pages of one rank and adds their digest partials into the
rank's digest once; see the source for the design.

Pages come as `(*lead, n, bw)` int32 words; every leading index is one
rank, whose `n` pages get their own digest.  `fletcher_pages_plain` is the
plain PyTorch version: the CPU path, and what the kernel is held against.
`run_digest_plain` is the kernel's digest in plain PyTorch, run by run,
for the tests only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.checksum import combine
from repro_torch.kernels import _build
from repro_torch.utils import as_u64, mul32, sum32, wrap32

# pages a CTA of the page-run sweeps (fletcher_pages, syndrome_pages), all
# of one rank: csrc/pages.cuh's kRunPages
RUN_PAGES = 8


def fletcher_pages_plain(blocks: torch.Tensor) -> torch.Tensor:
    """`(*lead, n, bw)` -> `(*lead, n, 2)` terms (A, B) mod 2^32."""
    bw = blocks.shape[-1]
    if bw >= 1 << 20:
        raise ValueError(f"block of {bw} words: int64 sums would overflow")
    w = bw - torch.arange(bw, device=blocks.device)
    u = as_u64(blocks)
    return wrap32(torch.stack([sum32(u, -1), sum32(u * w, -1)], dim=-1))


def fletcher_stream_plain(blocks: torch.Tensor) -> tuple:
    """Terms plus each rank's `(*lead, 2)` row digest."""
    terms = fletcher_pages_plain(blocks)
    return terms, combine(terms, blocks.shape[-1])


def run_digest_plain(terms: torch.Tensor, bw: int,
                     run_pages: int = RUN_PAGES) -> torch.Tensor:
    """Each rank's `(*lead, 2)` digest from its `(*lead, n, 2)` page terms
    as the page-run kernels form it: the rank's n pages cut into runs of
    `run_pages` (the last shorter), each page's share (A, B + (n - 1 -
    local) * bw * A) summed over its run, the runs' sums summed, all mod
    2^32.  Equal to `checksum.combine(terms, bw)` for every run length."""
    n = terms.shape[-2]
    a = as_u64(terms[..., 0])
    after = ((n - 1 - torch.arange(n, device=terms.device)) * bw) & 0xFFFFFFFF
    b = wrap32(as_u64(terms[..., 1]) + mul32(after, a))
    runs = [wrap32(torch.stack([sum32(a[..., i:i + run_pages], -1),
                                sum32(as_u64(b[..., i:i + run_pages]), -1)],
                               dim=-1))
            for i in range(0, n, run_pages)]
    return wrap32(sum32(as_u64(torch.stack(runs, dim=-2)), -2))


def _lib():
    lib = _build.library("fletcher")
    fn = lib.fletcher_pages_launch
    if not fn.argtypes:                     # declared once per process
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
    return fn


def fletcher_pages_meta(blocks: torch.Tensor, *, digest: bool,
                        name: str) -> tuple:
    """The kernel's checks and outputs, allocated as its wrapper allocates
    them, with no launch: on meta tensors, its shapes (the dry run)."""
    _build.check_pages(blocks, name)
    *lead, n, bw = blocks.shape
    terms = torch.empty(*lead, n, 2, dtype=torch.int32, device=blocks.device)
    dig = (torch.zeros(*lead, 2, dtype=torch.int32, device=blocks.device)
           if digest else None)
    return terms, dig


def fletcher_pages_cuda(blocks: torch.Tensor, *, digest: bool,
                        name: str) -> tuple:
    """Launch `fletcher_pages<digest>` once over every rank's pages.

    Returns (terms `(*lead, n, 2)`, digest `(*lead, 2)` or None) and counts
    one launch under `name`.
    """
    terms, dig = fletcher_pages_meta(blocks, digest=digest, name=name)
    *lead, n, bw = blocks.shape
    err = _lib()(blocks.data_ptr(), terms.data_ptr(),
                 dig.data_ptr() if digest else None, blocks.numel() // bw, bw, n,
                 int(digest), _build.stream_handle(blocks.device))
    _build.check(err, name)
    _build.count_launch(name)
    return terms, dig
