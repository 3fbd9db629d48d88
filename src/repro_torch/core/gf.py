"""GF(2^32) arithmetic for the generalized Reed-Solomon syndrome stack.

The zone's XOR parity tolerates one concurrent failure (Pangolin §3.1).
The syndrome stack extends it to any r <= 4 simultaneous rank losses,
Reed-Solomon style, while staying linear over XOR:

    S_k = g^(k·0)·row_0 ^ g^(k·1)·row_1 ^ ... ^ g^(k·(G-1))·row_{G-1}

for k = 0..r-1, with multiplication in GF(2^32) over the word lanes (S_0
is the XOR parity).  Losing e <= r ranks a_0 < ... < a_{e-1} leaves the
e x e Vandermonde system

    S_k ^ s_k = XOR_j g^(k·a_j) · X_j          k = 0..e-1

(s_k = the survivors' syndromes, X_j = the lost rows), invertible for any
distinct ranks because g is primitive.  The field is GF(2)[x] modulo the
primitive pentanomial x^32 + x^22 + x^2 + x + 1 (POLY = 0x400007), with
generator g = x = 2 — the reference's choice (core/gf.py), so every
coefficient and every product is the same u32.

Two layers, as in the reference:

  * host integers (`*_int`) — exact Python arithmetic for the scalar
    constants (rank coefficients, Vandermonde inverses);
  * tensors (`xtime` / `mul_const` / `mul_pow_g`) on int32 words holding
    u32 bit patterns — the plain versions the GF kernels
    (kernels/gf_parity.py) are held against.  Right shifts on int32 are
    arithmetic, so every `>> 31` is masked or used as a sign mask.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

MASK = (1 << 32) - 1
# x^32 + x^22 + x^2 + x + 1 — primitive over GF(2), generator g = x = 2.
POLY = 0x400007
ORDER = (1 << 32) - 1           # multiplicative group order (g is primitive)


# ---------------------------------------------------------------------------
# host-side exact arithmetic
# ---------------------------------------------------------------------------

def xtime_int(x: int) -> int:
    """Multiply by g (carry-less doubling) on a host integer."""
    x &= MASK
    return ((x << 1) & MASK) ^ (POLY if x >> 31 else 0)


def mul_int(a: int, b: int) -> int:
    """Full GF(2^32) product of two host integers (shift-and-add clmul)."""
    a &= MASK
    b &= MASK
    acc = 0
    while b:
        if b & 1:
            acc ^= a
        a = xtime_int(a)
        b >>= 1
    return acc


def pow_int(a: int, e: int) -> int:
    """a^e by square-and-multiply (e reduced mod the group order)."""
    if a == 0:
        return 0
    e %= ORDER
    r = 1
    while e:
        if e & 1:
            r = mul_int(r, a)
        a = mul_int(a, a)
        e >>= 1
    return r


def inv_int(a: int) -> int:
    """Multiplicative inverse a^(2^32 - 2); a must be nonzero."""
    if a & MASK == 0:
        raise ZeroDivisionError("GF(2^32) inverse of 0")
    return pow_int(a, ORDER - 1)


@functools.lru_cache(maxsize=None)
def pow_g_int(k: int) -> int:
    """g^k as a host integer (rank coefficient)."""
    r = 1
    for _ in range(k % ORDER if k >= ORDER else k):
        r = xtime_int(r)
    return r


@functools.lru_cache(maxsize=None)
def pow_g_table(g: int) -> tuple:
    """(g^0, ..., g^{G-1}) — per-rank S_1 coefficients for a zone of size G."""
    out, cur = [], 1
    for _ in range(g):
        out.append(cur)
        cur = xtime_int(cur)
    return tuple(out)


def pow_g_array(g: int) -> np.ndarray:
    """`pow_g_table` as a uint32 ndarray."""
    return np.asarray(pow_g_table(g), np.uint32)


@functools.lru_cache(maxsize=None)
def syndrome_table(g: int, r: int) -> tuple:
    """Entry [i][k] = g^(k·i): rank i's weight in syndrome S_k.  Column 0
    is all ones (S_0 = XOR parity); column 1 is `pow_g_table`."""
    return tuple(tuple(pow_g_int(k * i) for k in range(r))
                 for i in range(g))


def syndrome_array(g: int, r: int) -> np.ndarray:
    """`syndrome_table` as a (G, r) uint32 ndarray."""
    return np.asarray(syndrome_table(g, r), np.uint32)


def vandermonde_int(lost_ranks) -> tuple:
    """V[k][j] = g^(k·a_j) for the erased ranks a_j (rows = syndromes)."""
    ranks = tuple(int(a) for a in lost_ranks)
    e = len(ranks)
    return tuple(tuple(pow_g_int(k * a) for a in ranks) for k in range(e))


@functools.lru_cache(maxsize=None)
def inv_vandermonde_int(lost_ranks: tuple) -> tuple:
    """Exact inverse of the erasure Vandermonde matrix, host integers, by
    Gauss-Jordan over GF(2^32) (addition is XOR).  The points g^a_j are
    distinct and nonzero, so a nonzero pivot always exists."""
    ranks = tuple(int(a) for a in lost_ranks)
    if len(set(ranks)) != len(ranks):
        raise ValueError(f"erased ranks must be distinct, got {ranks}")
    e = len(ranks)
    m = [list(row) + [1 if i == k else 0 for i in range(e)]
         for k, row in enumerate(vandermonde_int(ranks))]
    for col in range(e):
        piv = next(i for i in range(col, e) if m[i][col])
        m[col], m[piv] = m[piv], m[col]
        scale = inv_int(m[col][col])
        m[col] = [mul_int(scale, v) for v in m[col]]
        for i in range(e):
            if i != col and m[i][col]:
                f = m[i][col]
                m[i] = [v ^ mul_int(f, w) for v, w in zip(m[i], m[col])]
    return tuple(tuple(row[e:]) for row in m)


def solve_e_int(deficits, lost_ranks) -> list:
    """Host oracle for the general solve: scalar syndromes -> lost words."""
    inv = inv_vandermonde_int(tuple(int(a) for a in lost_ranks))
    return [functools.reduce(
        lambda acc, kv: acc ^ mul_int(kv[1], deficits[kv[0]]),
        enumerate(row), 0) for row in inv]


def solve_two_int(p: int, q: int, rank_a: int, rank_b: int) -> tuple:
    """Host oracle for the 2x2 Vandermonde solve."""
    return tuple(solve_e_int((p, q), (rank_a, rank_b)))


# ---------------------------------------------------------------------------
# element-wise arithmetic on int32 words (the GF kernels' plain versions)
# ---------------------------------------------------------------------------

def xtime(x: torch.Tensor) -> torch.Tensor:
    """Element-wise multiply by g: (x << 1) ^ (POLY if bit 31 of x).
    `x >> 31` is arithmetic on int32 — all ones or zero — so it serves as
    the mask of POLY directly."""
    return (x << 1) ^ ((x >> 31) & POLY)


def mul_const(x: torch.Tensor, coeff) -> torch.Tensor:
    """Element-wise GF(2^32) product of int32 words by a coefficient.

    `coeff` is a host integer (any u32), or an int32 tensor that
    broadcasts against `x` (e.g. each rank's own coefficient).  Branch-free
    32-step clmul: step i XORs in x·g^i where coefficient bit i is set —
    bit-identical to `mul_int` per lane.
    """
    if not isinstance(coeff, torch.Tensor):
        coeff = torch.tensor(np.uint32(int(coeff) & MASK).view(np.int32),
                             device=x.device)
    acc = torch.zeros_like(x)
    cur = x
    for i in range(32):
        acc ^= cur & -((coeff >> i) & 1)
        cur = xtime(cur)
    return acc


def mul_pow_g(x: torch.Tensor, k: int) -> torch.Tensor:
    """Element-wise multiply by g^k for a host k: k doublings for small k,
    the full clmul by the host coefficient otherwise."""
    k = int(k)
    if k < 0:
        raise ValueError(f"negative power {k}")
    if k >= 32:
        return mul_const(x, pow_g_int(k))
    for _ in range(k):
        x = xtime(x)
    return x


def rank_syndrome_coeffs(group_size: int, r: int, mesh,
                         device) -> torch.Tensor:
    """Every device's syndrome coefficients, zone-stacked: `(*mesh_dims, r)`
    int32, entry `[..., k]` = g^(k·i) for the device at data coordinate i
    — the reference's `syndrome_array(G, r)[axis_index]` on each device.
    On a split mesh, the rows of this process's global ranks i."""
    table = syndrome_array(group_size, r).view(np.int32)
    lo = mesh.data_offset
    table = torch.from_numpy(table[lo:lo + mesh.local_group_size].copy())
    shape = [1] * len(mesh.shape) + [r]
    shape[mesh.data_dim] = mesh.local_group_size
    return table.reshape(shape).expand(*mesh.local_dims, r).to(
        device).contiguous()


def solve_e(deficits: torch.Tensor, lost_ranks) -> tuple:
    """Solve the e-erasure Vandermonde system element-wise.

    `deficits` is the `(e, ...)` stack S_k ^ s_k for the erased ranks a_j
    (distinct host ints).  The inverse matrix is exact host integers; each
    constant multiply other than by 1 runs the `gf_scale` kernel.  Returns
    the e lost rows' segments in `lost_ranks` order.
    """
    from repro_torch.kernels import ops as kops
    ranks = tuple(int(a) for a in lost_ranks)
    e = len(ranks)
    if deficits.shape[0] != e:
        raise ValueError(f"{deficits.shape[0]} deficit planes for {e} "
                         "erased ranks")
    out = []
    for row in inv_vandermonde_int(ranks):
        acc = None
        for k, c in enumerate(row):
            term = kops.gf_scale(deficits[k], c) if c != 1 else deficits[k]
            acc = term if acc is None else acc ^ term
        out.append(acc)
    return tuple(out)


def solve_two(p: torch.Tensor, q: torch.Tensor, rank_a: int,
              rank_b: int) -> tuple:
    """The e = 2 case of `solve_e` (the P + Q double-loss solve): the two
    lost rows' words from the deficits `p` (S_0) and `q` (S_1)."""
    rank_a, rank_b = int(rank_a), int(rank_b)
    if rank_a == rank_b:
        raise ValueError("double-loss solve needs two distinct ranks")
    return solve_e(torch.stack([p, q]), (rank_a, rank_b))

