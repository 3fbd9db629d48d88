"""The XOR parity patch: the Hopper kernel's wrapper and plain version.

The CUDA kernel `xor_words` (csrc/xor_parity.cu) replaces the Pallas
kernel `_xor2` (src/repro/kernels/xor_parity.py:41), the one body behind
`xor_delta` (the parity patch delta = old ^ new) and `xor_accum` (its
application parity ^ patch).  It takes any two contiguous int32 tensors of
one shape — pages, rows or a 1-D run of any length, at any 4-byte
alignment — and is bound by memory bytes (two reads and one write a
word).  `xor_words_plain` is the plain PyTorch version.

CUDA rather than Triton: the port has one build route (nvcc + ctypes,
`_build.py`), and a CPU-only PyTorch install, where the tests run, has no
`triton` to import a Triton wrapper against.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def check_operands(a: torch.Tensor, b: torch.Tensor, name: str) -> None:
    """Raise unless `a` and `b` are int32 words of one shape on one device
    (the reference asserts the same of its u32 operands)."""
    if a.shape != b.shape or a.dtype != torch.int32 or \
            b.dtype != torch.int32 or a.device != b.device:
        raise ValueError(f"{name}: expected int32 words of one shape on one "
                         f"device, got {tuple(a.shape)} {a.dtype} on "
                         f"{a.device} and {tuple(b.shape)} {b.dtype} on "
                         f"{b.device}")


def xor_words_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    check_operands(a, b, "xor_words")
    return a ^ b


def _lib():
    fn = _build.library("xor_parity").xor_words_launch
    if not fn.argtypes:                     # declared once per process
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                               ctypes.c_void_p]
    return fn


def xor_words_meta(a: torch.Tensor, b: torch.Tensor, *,
                   name: str) -> torch.Tensor:
    """The kernel's checks and output with no launch: on meta tensors, its
    shape (the dry run)."""
    check_operands(a, b, name)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: words must be contiguous")
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: expected a CUDA tensor, got {a.device}")
    return torch.empty_like(a)


def xor_words_cuda(a: torch.Tensor, b: torch.Tensor, *,
                   name: str) -> torch.Tensor:
    """Launch `xor_words` once: a fresh tensor of a ^ b.  Counts one launch
    under `name`."""
    out = xor_words_meta(a, b, name=name)
    dev = a.device
    err = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                 _build.stream_handle(dev))
    _build.check(err, name)
    _build.count_launch(name)
    return out
