"""Low-level helpers: bit-exact dtype<->word casting, padding, pytrees.

Parity and checksums are computed on bit patterns, never on float values,
so reconstruction is bit-exact for any dtype.  Every protected quantity is
a u32 word; torch has no arithmetic, shifts, reductions or index_put on
`torch.uint32`, so the port holds words as **int32 bit patterns**:

  * add / mul / xor on int32 wrap to the same 32 bits as u32 would;
  * right shifts are arithmetic on int32, so they are masked afterwards;
  * reductions and products that can exceed 32 bits go through int64
    (`as_u64`) and come back with `wrap32`.

Every function takes leading *batch* dims: a zone-stacked tensor is
`(*mesh_dims, *local_shape)` and the word view works per device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

PyTree = Any

# ---------------------------------------------------------------------------
# int32-as-u32 helpers
# ---------------------------------------------------------------------------

WORD = torch.int32


def as_u64(w: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values, as int64."""
    return w.to(torch.int64) & 0xFFFFFFFF


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int32 bit pattern of its value mod 2^32."""
    return ((x.to(torch.int64) + (1 << 31)) % (1 << 32) - (1 << 31)
            ).to(WORD)


def word(v: int) -> int:
    """A u32 constant (e.g. 0xDEADBEEF) as the int32 with the same bits."""
    v = int(v) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def mul32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x * y) mod 2^32 for int64 operands in [0, 2^32), exactly.

    The full product can reach 2^64 and overflow int64, so y is split into
    16-bit halves: x*y_lo < 2^48 and x*y_hi < 2^48 both fit.
    """
    lo = x * (y & 0xFFFF)
    hi = ((x * (y >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def sum32(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Sum of int64 values mod 2^32 (result in [0, 2^32), int64)."""
    s = x.sum() if dim is None else x.sum(dim=dim)
    return s & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the reference's PRNG key words (threefry-2x32), on the host
# ---------------------------------------------------------------------------
# A redo record carries the step's RNG key as two u32 words: the reference
# logs `key_data(fold_in(PRNGKey(seed), cursor))`.  JAX's default PRNG is
# threefry-2x32: PRNGKey(seed) is the words (0, seed mod 2^32) under JAX's
# default 32-bit integers, and fold_in(key, d) hashes the count (0, d)
# under the key.

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: Sequence[int], count: Sequence[int]) -> list:
    """The 20-round threefry-2x32 hash of one count pair under `key`."""
    k0, k1 = key[0] & _M32, key[1] & _M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (count[0] + ks[0]) & _M32, (count[1] + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return [x0, x1]


def prng_key(seed: int) -> list:
    """The words of the reference's `jax.random.PRNGKey(seed)`."""
    return [0, int(seed) & _M32]


def fold_in(key: Sequence[int], data: int) -> list:
    """The words of `jax.random.fold_in(key, data)` (data as a u32)."""
    return threefry2x32(key, [0, int(data) & _M32])


# ---------------------------------------------------------------------------
# dtype <-> u32 word views
# ---------------------------------------------------------------------------

_U32_DTYPES = (torch.float32, torch.int32, torch.uint32)
_U16_DTYPES = (torch.bfloat16, torch.float16, torch.int16, torch.uint16)
_U8_DTYPES = (torch.int8, torch.uint8)


def _check(dtype) -> None:
    if dtype not in _U32_DTYPES + _U16_DTYPES + _U8_DTYPES:
        raise ValueError(f"unsupported dtype for word view: {dtype}")


def words_per_elem(dtype) -> float:
    """u32 words per element of `dtype` (fractional below 32 bits)."""
    _check(dtype)
    return dtype.itemsize / 4


def num_words(shape: Sequence[int], dtype) -> int:
    """Number of u32 words needed to hold a tensor (with padding)."""
    _check(dtype)
    n = math.prod(shape)
    if dtype in _U32_DTYPES:
        return n
    if dtype in _U16_DTYPES:
        return (n + 1) // 2
    return (n + 3) // 4


_LANE = {4: WORD, 2: torch.int16, 1: torch.uint8}


def to_words(x: torch.Tensor, batch_dims: int = 0) -> torch.Tensor:
    """Bit-exact view of `x` as int32 words, flattened after `batch_dims`.

    `(*lead, *shape)` -> `(*lead, num_words(shape))`; 16- and 8-bit types
    pack little-endian (the bytes' own order) and zero-pad the last word,
    as the reference does.
    """
    _check(x.dtype)
    lead = tuple(x.shape[:batch_dims])
    b = x.reshape(*lead, -1).contiguous().view(torch.uint8)
    pad = (-b.shape[-1]) % 4
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    return b.view(WORD)


def from_words(w: torch.Tensor, shape: Sequence[int], dtype) -> torch.Tensor:
    """Inverse of :func:`to_words`: `(*lead, k)` words -> `(*lead, *shape)`."""
    _check(dtype)
    lead = tuple(w.shape[:-1])
    shape = tuple(shape)
    n = math.prod(shape)
    flat = w.contiguous().view(_LANE[dtype.itemsize])[..., :n]
    return flat.contiguous().view(dtype).reshape(*lead, *shape)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """The device of an entry point: `None` means the card, and a missing
    card raises — nothing falls back to the CPU unless asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' "
            "to run the kernels' plain versions on the CPU")
    return dev


def to_device(values, device) -> torch.Tensor:
    """Host values (a list, a numpy array) as a tensor on `device`.  On the
    card the copy is enqueued without blocking: a blocking copy would
    synchronise the stream, and a commit must not wait for the device."""
    t = torch.as_tensor(values)
    return t.to(device, non_blocking=True)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_to(x: torch.Tensor, n: int, value: int = 0) -> torch.Tensor:
    """Pad the last dim of `x` with `value` up to length `n`."""
    m = x.shape[-1]
    if m == n:
        return x
    if m > n:
        raise ValueError(f"pad_to: length {m} exceeds target {n}")
    return torch.nn.functional.pad(x, (0, n - m), value=value)


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Placement of one pytree leaf inside the flat word row (a 'zone object')."""
    offset: int          # word offset in the row
    n_words: int         # words occupied (incl. sub-word padding)
    shape: tuple         # local shard shape
    dtype: Any           # torch dtype


# ---------------------------------------------------------------------------
# pytrees: dicts (keys sorted, as JAX orders them), lists, tuples, None;
# anything else — tensors, arrays, tuple subclasses such as specs — is a leaf
# ---------------------------------------------------------------------------
# torch.utils._pytree keeps dict insertion order; the row layout must place
# leaves in the reference's (sorted-key) order to be byte-equal to it.

@dataclasses.dataclass(frozen=True)
class TreeDef:
    kind: str                    # "leaf" | "none" | "dict" | "list" | "tuple"
    keys: tuple = ()
    children: tuple = ()


def tree_flatten(tree: PyTree) -> tuple:
    if tree is None:
        return [], TreeDef("none")
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        subs = [tree_flatten(tree[k]) for k in keys]
        kind = "dict"
    elif type(tree) in (list, tuple):       # a P spec (tuple subclass) is a leaf
        keys = ()
        subs = [tree_flatten(t) for t in tree]
        kind = "list" if isinstance(tree, list) else "tuple"
    else:
        return [tree], TreeDef("leaf")
    leaves = [l for ls, _ in subs for l in ls]
    return leaves, TreeDef(kind, keys, tuple(d for _, d in subs))


def tree_unflatten(treedef: TreeDef, leaves: Sequence) -> PyTree:
    it = iter(leaves)

    def build(d: TreeDef):
        if d.kind == "leaf":
            return next(it)
        if d.kind == "none":
            return None
        kids = [build(c) for c in d.children]
        if d.kind == "dict":
            return dict(zip(d.keys, kids))
        return kids if d.kind == "list" else tuple(kids)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: too many leaves")
    return out


def tree_leaves(tree: PyTree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree: PyTree, *rest: PyTree) -> PyTree:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(t)[0] for t in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def _host(x):
    """A leaf as a numpy array on the host (bf16 as its 16-bit pattern)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.numpy()


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def tree_bytes(tree: PyTree) -> int:
    """Total payload bytes of a pytree of tensors (meta ones included) or
    arrays."""
    return sum(math.prod(x.shape) * (x.element_size()
                                     if isinstance(x, torch.Tensor)
                                     else x.dtype.itemsize)
               for x in tree_leaves(tree))


def tree_equal_bits(a: PyTree, b: PyTree) -> bool:
    """Bit-exact equality of two pytrees (on the host): the same leaf
    count, and each pair of the same shape, dtype and bytes."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if tuple(x.shape) != tuple(y.shape) or _dtype(x) != _dtype(y):
            return False
        if _host(x).tobytes() != _host(y).tobytes():
            return False
    return True


def _paths(tree: PyTree, path: str = "") -> list:
    """(key path, leaf) pairs in `tree_flatten`'s order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        f"{path}[{k!r}]")]
    if type(tree) in (list, tuple):
        return [p for i, t in enumerate(tree) for p in _paths(t,
                                                             f"{path}[{i}]")]
    return [] if tree is None else [(path, tree)]


def fingerprint(tree: PyTree) -> int:
    """A structural fingerprint for layout-compatibility checks: equal
    for trees of the same key paths, shapes and dtypes, different when
    any of them differs (a hash of strings: its value changes from one
    process to the next)."""
    return hash(tuple((path, tuple(x.shape), _dtype(x))
                      for path, x in _paths(tree)))


def abstract(tree: PyTree) -> PyTree:
    """The shapes and dtypes of a pytree of tensors (or arrays), as
    `device="meta"` tensors: what a layout is built from, holding no
    bytes (the reference's `ShapeDtypeStruct` pytree)."""
    def meta(x):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
    return tree_map(meta, tree)


def is_abstract(tree: PyTree) -> bool:
    """True for a pytree of `device="meta"` tensors only (a cold state)."""
    leaves = tree_leaves(tree)
    return bool(leaves) and all(
        isinstance(x, torch.Tensor) and x.is_meta for x in leaves)
