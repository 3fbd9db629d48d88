"""The fused commit sweep: the Hopper kernel's wrapper and plain version.

The CUDA kernel `commit_pages<VERIFY, DIGEST, ACC>` (csrc/commit_fused.cu)
replaces the Pallas kernels `fused_commit`
(src/repro/kernels/commit_fused.py:83), `_verify_call` (:103, behind
`fused_verify_commit` and `fused_commit_old_terms`),
`_verify_stream_call` (:393, behind `fused_verify_commit_stream`),
`fused_accum_commit` (:185) and `fused_accum_commit_stream` (:436).  It
reads (old, new) once and writes the delta, the new page terms and — with
VERIFY — the old page terms XOR the stored ones.  With ACC (the
deferred-epoch engine's in-window step) it also reads the epoch
accumulator, writes acc ^ old ^ new in the delta's place and the old
page's raw terms in the verify terms' place.  It is bound by memory bytes
(two page reads, three with ACC, and one page write per page); see the
source.

Pages come as `(*lead, n, bw)` int32 words; every leading index is one
rank.  `commit_pages_plain` is the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.checksum import combine
from repro_torch.kernels import _build
from repro_torch.kernels.fletcher import fletcher_pages_plain


def commit_pages_plain(old: torch.Tensor, new: torch.Tensor,
                       stored: Optional[torch.Tensor] = None,
                       digest: bool = False,
                       acc: Optional[torch.Tensor] = None) -> tuple:
    """(delta, new terms, old terms ^ stored or None, digest or None); with
    `acc`: (acc ^ old ^ new, new terms, old terms, digest or None), the
    accumulator's successor a fresh tensor."""
    if old.shape != new.shape:
        raise ValueError(f"old {tuple(old.shape)} vs new {tuple(new.shape)}")
    if acc is not None and (stored is not None or acc.shape != new.shape):
        raise ValueError(f"acc {tuple(acc.shape)} must match new "
                         f"{tuple(new.shape)}, without stored terms")
    terms = fletcher_pages_plain(new)
    mism = None
    if stored is not None or acc is not None:
        mism = fletcher_pages_plain(old)
        if stored is not None:
            mism = mism ^ stored
    dig = combine(terms, new.shape[-1]) if digest else None
    delta = old ^ new if acc is None else acc ^ old ^ new
    return delta, terms, mism, dig


def _lib():
    lib = _build.library("commit_fused")
    fn = lib.commit_pages_launch
    if not fn.argtypes:                     # declared once per process
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def commit_pages_cuda(old: torch.Tensor, new: torch.Tensor,
                      stored: Optional[torch.Tensor] = None, *,
                      digest: bool, name: str,
                      acc: Optional[torch.Tensor] = None) -> tuple:
    """Launch `commit_pages<stored is not None, digest, acc is not None>`
    once over every rank's pages; same returns as `commit_pages_plain`
    (the accumulator's successor a fresh tensor).  Counts one launch under
    `name`."""
    _build.check_pages(old, name)
    _build.check_pages(new, name)
    if old.shape != new.shape or old.device != new.device:
        raise ValueError(f"{name}: old {tuple(old.shape)} on {old.device} "
                         f"vs new {tuple(new.shape)} on {new.device}")
    *lead, n, bw = new.shape
    dev = new.device
    verify, accum = stored is not None, acc is not None
    if verify and (stored.shape != (*lead, n, 2) or stored.dtype != torch.int32
                   or stored.device != dev or not stored.is_contiguous()):
        raise ValueError(f"{name}: stored terms must be contiguous int32 "
                         f"{(*lead, n, 2)} on {dev}")
    if accum:
        _build.check_pages(acc, name)
        if verify or acc.shape != new.shape or acc.device != dev:
            raise ValueError(f"{name}: acc {tuple(acc.shape)} on "
                             f"{acc.device} must match new "
                             f"{tuple(new.shape)} on {dev}, without stored "
                             "terms")
    delta = torch.empty_like(new)
    terms = torch.empty(*lead, n, 2, dtype=torch.int32, device=dev)
    mism = torch.empty_like(terms) if verify or accum else None
    dig = torch.zeros(*lead, 2, dtype=torch.int32, device=dev) if digest else None
    err = _lib()(old.data_ptr(), new.data_ptr(),
                 stored.data_ptr() if verify else None,
                 acc.data_ptr() if accum else None, delta.data_ptr(),
                 terms.data_ptr(), None if mism is None else mism.data_ptr(),
                 dig.data_ptr() if digest else None, new.numel() // bw, bw, n,
                 int(verify), int(accum), int(digest),
                 _build.stream_handle(dev))
    _build.check(err, name)
    _build.count_launch(name)
    return delta, terms, mism, dig
