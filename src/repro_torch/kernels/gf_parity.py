"""The GF(2^32) syndrome sweeps: the Hopper kernels' wrappers and plain
versions.

Two CUDA kernels (csrc/gf_parity.cu) replace the four Pallas calls of
src/repro/kernels/gf_parity.py:

  * `syndrome_pages<R, VERIFY, DIGEST>` — `_s_call` (:151, behind
    `fused_commit_s`, `fused_verify_commit_s`, `fused_commit_old_terms_s`)
    and `_s_stream_call` (:311, behind `fused_commit_s_stream`,
    `fused_verify_commit_s_stream`): one read of (old, new), the r
    weighted delta planes, the new page terms [, old terms ^ stored]
    [, the per-rank row digest];
  * `weight_words<R, RAW0>` — `sdelta_stack` (:224) and `gf_scale` (:83):
    element-wise weighting of words into planes.

Both functions are bound by their bytes, and both run the table multiply
(eight 16-entry tables a coefficient in shared memory, eight lookups a
word; see the source and PERF.md §6).  `syndrome_pages` takes runs of
`fletcher.RUN_PAGES` pages of one rank a CTA, so it builds a rank's
tables once a run and adds the run's digest partials once.
`table_build_plain` / `table_mul_plain` are that multiply in plain
PyTorch, on the same chunking, and `syndrome_runs_plain` the whole sweep
as the kernel forms it, for the tests only.
Pages come as `(*lead, n, bw)` int32 words and words as
`(*lead, m)`; every leading index is one rank, whose coefficients are the
matching row of a `(*lead, r)` int32 table (`gf.rank_syndrome_coeffs`).
The weighted planes come back as `(*lead, r, n, bw)` / `(*lead, r, m)`,
plane-major within each rank.  The `*_plain` functions are the plain
PyTorch versions: the CPU path, and what the kernels are held against.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import gf
from repro_torch.kernels import _build
from repro_torch.kernels.commit_fused import commit_pages_plain
from repro_torch.kernels.fletcher import (RUN_PAGES, fletcher_pages_plain,
                                          run_digest_plain)

MAX_R = 4
# a weight_words block's share of words: where a launch goes from one block
# to two (csrc/gf_parity.cu, kShare4 uint4)
SHARE_WORDS = 4096
CHUNKS = 8                                  # 4-bit chunks of a word


def table_build_plain(coeff) -> torch.Tensor:
    """The table multiply's tables of a coefficient, as gf.cuh's
    `build_table` fills them: `(*c.shape, 8, 16)` int32, entry [j, v] =
    coeff·(v << 4j), each by the 32-step multiply.  `coeff` is a host u32
    or an int32 tensor of coefficients."""
    tensor = isinstance(coeff, torch.Tensor)
    dev = coeff.device if tensor else None
    v = torch.arange(16, dtype=torch.int32, device=dev)
    shifts = 4 * torch.arange(CHUNKS, dtype=torch.int32, device=dev)
    chunks = v << shifts[:, None]                        # (8, 16)
    if not tensor:
        return gf.mul_const(chunks, coeff)
    return gf.mul_const(chunks.expand(*coeff.shape, CHUNKS, 16),
                        coeff[..., None, None])


def table_mul_plain(x: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """c·x = XOR_j T_j[(x >> 4j) & 15], gf.cuh's `table_mul`: `tables`
    `(8, 16)` for one coefficient over every word of x, or `(*lead, 8, 16)`
    for x `(*lead, m)`, each leading index its own coefficient."""
    acc = torch.zeros_like(x)
    for j in range(CHUNKS):
        idx = ((x >> (4 * j)) & 15).long()
        t = tables[..., j, :]
        acc ^= t[idx] if t.dim() == 1 else torch.gather(t, -1, idx)
    return acc


def gf_scale_plain(x: torch.Tensor, coeff: int) -> torch.Tensor:
    """y = coeff · x, element-wise, for a host coefficient."""
    return gf.mul_const(x, coeff)


def sdelta_stack_plain(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """`(*lead, m)` words, `(*lead, r)` coefficients -> `(*lead, r, m)`:
    plane 0 raw (g^0 = 1), plane k = coeffs[..., k] · x."""
    r = coeffs.shape[-1]
    return torch.stack([x] + [gf.mul_const(x, coeffs[..., k:k + 1])
                              for k in range(1, r)], dim=-2)


def syndrome_pages_plain(old: torch.Tensor, new: torch.Tensor,
                         coeffs: torch.Tensor,
                         stored: Optional[torch.Tensor] = None,
                         digest: bool = False) -> tuple:
    """(sdelta `(*lead, r, n, bw)`, new terms, old terms ^ stored or None,
    digest or None)."""
    delta, terms, old_terms, dig = commit_pages_plain(
        old, new, old_terms=stored is not None, digest=digest)
    mism = None if stored is None else old_terms ^ stored
    *lead, n, bw = delta.shape
    sdelta = sdelta_stack_plain(delta.reshape(*lead, n * bw), coeffs)
    return sdelta.reshape(*lead, -1, n, bw), terms, mism, dig


def syndrome_runs_plain(old: torch.Tensor, new: torch.Tensor,
                        coeffs: torch.Tensor,
                        stored: Optional[torch.Tensor] = None,
                        digest: bool = False,
                        run_pages: int = RUN_PAGES) -> tuple:
    """`syndrome_pages` as the kernel forms it, in plain PyTorch: plane 0
    the raw delta, plane k the table multiply of the delta by each rank's
    coeffs[..., k], the digest from runs of `run_pages` pages
    (`run_digest_plain`).  Same returns as `syndrome_pages_plain`."""
    delta = old ^ new
    *lead, n, bw = delta.shape
    flat = delta.reshape(*lead, n * bw)
    planes = [flat] + [table_mul_plain(flat, table_build_plain(
        coeffs[..., k])) for k in range(1, coeffs.shape[-1])]
    sdelta = torch.stack(planes, dim=-2).reshape(*lead, -1, n, bw)
    terms = fletcher_pages_plain(new)
    mism = None if stored is None else fletcher_pages_plain(old) ^ stored
    dig = run_digest_plain(terms, bw, run_pages) if digest else None
    return sdelta, terms, mism, dig


def _fn(symbol: str, argtypes: list):
    fn = getattr(_build.library("gf_parity"), symbol)
    if not fn.argtypes:                     # declared once per process
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def _check_coeffs(coeffs: torch.Tensor, lead, device, name: str) -> int:
    r = coeffs.shape[-1] if coeffs.dim() else 0
    if (coeffs.dtype != torch.int32 or coeffs.device != device
            or tuple(coeffs.shape[:-1]) != tuple(lead)
            or not 2 <= r <= MAX_R or not coeffs.is_contiguous()):
        raise ValueError(f"{name}: coefficients must be a contiguous int32 "
                         f"{(*lead, 'r')} table on {device} with 2 <= r <= "
                         f"{MAX_R}, got {tuple(coeffs.shape)} "
                         f"{coeffs.dtype} on {coeffs.device}")
    return r


def syndrome_pages_meta(old: torch.Tensor, new: torch.Tensor,
                        coeffs: torch.Tensor,
                        stored: Optional[torch.Tensor] = None, *,
                        digest: bool, name: str) -> tuple:
    """The kernel's checks and outputs, allocated as its wrapper allocates
    them, with no launch: on meta tensors, its shapes (the dry run)."""
    _build.check_pages(old, name)
    _build.check_pages(new, name)
    if old.shape != new.shape or old.device != new.device:
        raise ValueError(f"{name}: old {tuple(old.shape)} on {old.device} "
                         f"vs new {tuple(new.shape)} on {new.device}")
    *lead, n, bw = new.shape
    dev = new.device
    r = _check_coeffs(coeffs, lead, dev, name)
    verify = stored is not None
    if verify and (stored.shape != (*lead, n, 2) or stored.dtype != torch.int32
                   or stored.device != dev or not stored.is_contiguous()):
        raise ValueError(f"{name}: stored terms must be contiguous int32 "
                         f"{(*lead, n, 2)} on {dev}")
    sdelta = torch.empty(*lead, r, n, bw, dtype=torch.int32, device=dev)
    terms = torch.empty(*lead, n, 2, dtype=torch.int32, device=dev)
    mism = torch.empty_like(terms) if verify else None
    dig = torch.zeros(*lead, 2, dtype=torch.int32, device=dev) if digest else None
    return sdelta, terms, mism, dig


def syndrome_pages_cuda(old: torch.Tensor, new: torch.Tensor,
                        coeffs: torch.Tensor,
                        stored: Optional[torch.Tensor] = None, *,
                        digest: bool, name: str) -> tuple:
    """Launch `syndrome_pages<r, stored is not None, digest>` once over every
    rank's pages; same returns as `syndrome_pages_plain`.  Counts one launch
    under `name`."""
    sdelta, terms, mism, dig = syndrome_pages_meta(
        old, new, coeffs, stored, digest=digest, name=name)
    verify = stored is not None
    *lead, n, bw = new.shape
    r = coeffs.shape[-1]
    dev = new.device
    fn = _fn("syndrome_pages_launch", [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    err = fn(old.data_ptr(), new.data_ptr(), coeffs.data_ptr(),
             stored.data_ptr() if verify else None, sdelta.data_ptr(),
             terms.data_ptr(), mism.data_ptr() if verify else None,
             dig.data_ptr() if digest else None, new.numel() // bw, bw, n, r,
             int(verify), int(digest), _build.stream_handle(dev))
    _build.check(err, name)
    _build.count_launch(name)
    return sdelta, terms, mism, dig


def _weight_words(x, coeffs, scalar, lead, m, r, raw0, out, name):
    fn = _fn("weight_words_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    err = fn(x.data_ptr(), None if coeffs is None else coeffs.data_ptr(),
             scalar, out.data_ptr(), lead, m, r, int(raw0),
             _build.stream_handle(x.device))
    _build.check(err, name)
    _build.count_launch(name)
    return out


def sdelta_stack_meta(x: torch.Tensor, coeffs: torch.Tensor, *,
                      name: str) -> torch.Tensor:
    """The kernel's checks and output with no launch (the dry run)."""
    _build.check_pages(x, name, pages=False)
    *lead, m = x.shape
    r = _check_coeffs(coeffs, lead, x.device, name)
    return torch.empty(*lead, r, m, dtype=torch.int32, device=x.device)


def sdelta_stack_cuda(x: torch.Tensor, coeffs: torch.Tensor, *,
                      name: str) -> torch.Tensor:
    """Launch `weight_words<r, RAW0=true>`: `(*lead, m)` -> `(*lead, r, m)`
    from one read of x.  Counts one launch under `name`."""
    out = sdelta_stack_meta(x, coeffs, name=name)
    m, r = x.shape[-1], coeffs.shape[-1]
    return _weight_words(x, coeffs, 0, x.numel() // m, m, r, True, out, name)


def gf_scale_meta(x: torch.Tensor, coeff: int, *, name: str) -> torch.Tensor:
    """The kernel's checks and output with no launch (the dry run)."""
    _build.check_pages(x, name, pages=False)
    return torch.empty_like(x)


def gf_scale_cuda(x: torch.Tensor, coeff: int, *, name: str) -> torch.Tensor:
    """Launch `weight_words<1, RAW0=false>` over every word of x (any
    contiguous shape with a multiple of 4 words a row).  Counts one launch
    under `name`."""
    out = gf_scale_meta(x, coeff, name=name)
    return _weight_words(x, None, int(coeff) & gf.MASK, 1, x.numel(), 1,
                         False, out, name)
