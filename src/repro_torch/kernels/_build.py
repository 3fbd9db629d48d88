"""Build the CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain `extern "C"` launcher and compiles on
its own into `build/repro_torch/<name>-<hash>.so` at the repo root (the
hash covers the source, every `csrc/` header it includes, and the flags,
so an edited source or header never loads a stale library).  `build()` starts one nvcc per missing library, all at
once, and waits for them; the first kernel call builds everything.

Every launcher takes the raw handle of PyTorch's current stream
(`stream_handle`) and returns the `cudaError_t` of its launch, and
`check` raises on a non-zero one.  `LAUNCHES` counts each entry point's
kernel launches: a wrapper adds one right after its launch, and nowhere
else, so a run can show which kernels its path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fletcher", "commit_fused", "gf_parity", "xor_parity")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)

LAUNCHES: dict = {}
_libs: dict = {}
_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build where the "
                           "CUDA toolkit is installed (set CUDA_HOME)")
    return path


def compiled_files(name: str) -> list:
    """`csrc/<name>.cu` and every header under `csrc/` that it includes,
    directly or through another header (`#include "..."` only)."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = path.parent / inc.decode()
            if header.is_file():
                todo.append(header)
    return files


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in compiled_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict:
    """Compile every library not yet built; returns {name: path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            jobs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for name, out, tmp, proc in jobs:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode:
                errors.append(f"{name}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    finally:
        for *_, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {name: library_path(name) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu` (built on first use)."""
    with _lock:
        if name not in _libs:
            path = build()[name]
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def stream_handle(device: torch.device) -> int:
    """The raw `cudaStream_t` of PyTorch's current stream on a CUDA device,
    as an int for ctypes: what `torch.cuda.current_stream(device)
    .cuda_stream` gives, without building a `torch.cuda.Stream` object on
    every launch.  `device` is a tensor's, so its index is set."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError_t "
                           f"{err}")


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launches() -> None:
    LAUNCHES.clear()


def check_pages(x, name: str, pages: bool = True) -> None:
    """Raise unless `x` is what the kernels take: a contiguous, 16-byte
    aligned CUDA int32 tensor of `(..., n, bw)` pages with bw % 4 == 0 (or,
    with `pages=False`, of `(..., m)` words with m % 4 == 0).  A meta
    tensor, which holds no bytes, passes for a CUDA one (the dry run)."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise ValueError(f"{name}: expected int32 words, got {x.dtype}")
    what = "(..., n, bw) pages with bw" if pages else "(..., m) words with m"
    if x.dim() < (2 if pages else 1) or x.shape[-1] % 4 or x.shape[-1] == 0:
        raise ValueError(f"{name}: expected {what} % 4 == 0, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: words must be contiguous and 16-byte "
                         "aligned")
