"""The fused commit sweep: the Hopper kernel's wrapper and plain version.

The CUDA kernel `commit_pages<MODE, DIGEST>` (csrc/commit_fused.cu)
replaces the Pallas kernels `fused_commit`
(src/repro/kernels/commit_fused.py:83), `_verify_call` (:103, behind
`fused_verify_commit` and `fused_commit_old_terms`),
`_verify_stream_call` (:393, behind `fused_verify_commit_stream`),
`fused_accum_commit` (:185) and `fused_accum_commit_stream` (:436).  It
reads (old, new) once and writes the delta and the new page terms, and
beside them, by its mode: with `stored`, each old page's verdict against
its stored terms (`bad`, a bool a page, formed in the sweep); with
`old_terms`, the old page's raw terms (no stored table is read); with
`acc` (the deferred-epoch engine's in-window step), it also reads the
epoch accumulator and writes acc ^ old ^ new in the delta's place and the
old page's raw terms.  It is bound by memory bytes (two page reads, three
with `acc`, and one page write per page).  A CTA takes a run of
`fletcher.RUN_PAGES` pages of one rank, a warp a page; see the source.

Pages come as `(*lead, n, bw)` int32 words; every leading index is one
rank.  `commit_pages_plain` is the plain PyTorch version: the CPU path,
and what the kernel is held against.  `commit_runs_plain` is the kernel's
structure in plain PyTorch — the digest summed run by run, the verdict
from the old page's (A, B) against the stored pair — for the tests only.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.checksum import combine
from repro_torch.kernels import _build
from repro_torch.kernels.fletcher import (RUN_PAGES, fletcher_pages_plain,
                                          run_digest_plain)

# commit_pages_launch's modes (csrc/commit_fused.cu's Mode)
COMMIT, VERIFY, OLD_TERMS, ACCUM = range(4)


def _mode(stored, old_terms, acc) -> int:
    if (stored is not None) + bool(old_terms) + (acc is not None) > 1:
        raise ValueError("commit_pages takes one of stored, old_terms and "
                         "acc")
    if stored is not None:
        return VERIFY
    return ACCUM if acc is not None else OLD_TERMS if old_terms else COMMIT


def _check_plain(old, new, stored, acc) -> None:
    if old.shape != new.shape:
        raise ValueError(f"old {tuple(old.shape)} vs new {tuple(new.shape)}")
    if acc is not None and (stored is not None or acc.shape != new.shape):
        raise ValueError(f"acc {tuple(acc.shape)} must match new "
                         f"{tuple(new.shape)}, without stored terms")


def commit_pages_plain(old: torch.Tensor, new: torch.Tensor,
                       stored: Optional[torch.Tensor] = None, *,
                       old_terms: bool = False, digest: bool = False,
                       acc: Optional[torch.Tensor] = None) -> tuple:
    """(delta, new terms, side, digest or None).  side: with `stored`, bad
    `(*lead, n)` bool, True where the old page's terms differ from the
    stored ones; with `old_terms` or `acc`, the old page's terms; else
    None.  With `acc` the delta is acc ^ old ^ new (a fresh tensor)."""
    _check_plain(old, new, stored, acc)
    mode = _mode(stored, old_terms, acc)
    terms = fletcher_pages_plain(new)
    side = None
    if mode != COMMIT:
        side = fletcher_pages_plain(old)
        if mode == VERIFY:
            side = (side != stored).any(dim=-1)
    dig = combine(terms, new.shape[-1]) if digest else None
    delta = old ^ new if acc is None else acc ^ old ^ new
    return delta, terms, side, dig


def commit_runs_plain(old: torch.Tensor, new: torch.Tensor,
                      stored: Optional[torch.Tensor] = None, *,
                      old_terms: bool = False, digest: bool = False,
                      acc: Optional[torch.Tensor] = None,
                      run_pages: int = RUN_PAGES) -> tuple:
    """`commit_pages` as the kernel forms it, in plain PyTorch: the digest
    summed in runs of `run_pages` pages (`fletcher.run_digest_plain`), the
    verdict a page from the old page's A and B each against the stored
    pair, the old terms raw.  Same returns as `commit_pages_plain`."""
    _check_plain(old, new, stored, acc)
    mode = _mode(stored, old_terms, acc)
    bw = new.shape[-1]
    terms = fletcher_pages_plain(new)
    olds = fletcher_pages_plain(old) if mode != COMMIT else None
    side = olds
    if mode == VERIFY:
        side = ((olds[..., 0] != stored[..., 0])
                | (olds[..., 1] != stored[..., 1]))
    dig = run_digest_plain(terms, bw, run_pages) if digest else None
    delta = old ^ new
    if acc is not None:
        delta = delta ^ acc
    return delta, terms, side, dig


def _lib():
    lib = _build.library("commit_fused")
    fn = lib.commit_pages_launch
    if not fn.argtypes:                     # declared once per process
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
    return fn


def commit_pages_meta(old: torch.Tensor, new: torch.Tensor,
                      stored: Optional[torch.Tensor] = None, *,
                      old_terms: bool = False, digest: bool, name: str,
                      acc: Optional[torch.Tensor] = None) -> tuple:
    """The kernel's checks and outputs, allocated as its wrapper allocates
    them, with no launch: on meta tensors, its shapes (the dry run)."""
    _build.check_pages(old, name)
    _build.check_pages(new, name)
    if old.shape != new.shape or old.device != new.device:
        raise ValueError(f"{name}: old {tuple(old.shape)} on {old.device} "
                         f"vs new {tuple(new.shape)} on {new.device}")
    *lead, n, bw = new.shape
    dev = new.device
    mode = _mode(stored, old_terms, acc)
    if mode == VERIFY and (
            stored.shape != (*lead, n, 2) or stored.dtype != torch.int32
            or stored.device != dev or not stored.is_contiguous()):
        raise ValueError(f"{name}: stored terms must be contiguous int32 "
                         f"{(*lead, n, 2)} on {dev}")
    if mode == ACCUM:
        _build.check_pages(acc, name)
        if acc.shape != new.shape or acc.device != dev:
            raise ValueError(f"{name}: acc {tuple(acc.shape)} on "
                             f"{acc.device} must match new "
                             f"{tuple(new.shape)} on {dev}, without stored "
                             "terms")
    delta = torch.empty_like(new)
    terms = torch.empty(*lead, n, 2, dtype=torch.int32, device=dev)
    side = (torch.empty(*lead, n, dtype=torch.bool, device=dev)
            if mode == VERIFY else torch.empty_like(terms)
            if mode != COMMIT else None)
    dig = torch.zeros(*lead, 2, dtype=torch.int32, device=dev) if digest else None
    return delta, terms, side, dig


def commit_pages_cuda(old: torch.Tensor, new: torch.Tensor,
                      stored: Optional[torch.Tensor] = None, *,
                      old_terms: bool = False, digest: bool, name: str,
                      acc: Optional[torch.Tensor] = None) -> tuple:
    """Launch `commit_pages` once over every rank's pages, in the mode that
    `stored`, `old_terms` or `acc` names (at most one); same returns as
    `commit_pages_plain` (the accumulator's successor a fresh tensor).
    Counts one launch under `name`."""
    delta, terms, side, dig = commit_pages_meta(
        old, new, stored, old_terms=old_terms, digest=digest, name=name,
        acc=acc)
    mode = _mode(stored, old_terms, acc)
    bw, n, dev = new.shape[-1], new.shape[-2], new.device
    err = _lib()(old.data_ptr(), new.data_ptr(),
                 stored.data_ptr() if mode == VERIFY else None,
                 acc.data_ptr() if mode == ACCUM else None, delta.data_ptr(),
                 terms.data_ptr(), None if side is None else side.data_ptr(),
                 dig.data_ptr() if digest else None, new.numel() // bw, bw, n,
                 mode, int(digest), _build.stream_handle(dev))
    _build.check(err, name)
    _build.count_launch(name)
    return delta, terms, side, dig
