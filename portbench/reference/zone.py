"""Plain reference of Pangolin's zone protection, written from its
definition and sharing no code with the program under test.

A zone of G data ranks keeps, for each rank i, its shards of every state
leaf as little-endian 32-bit words, concatenated in sorted key order and
zero-padded to a whole number of G pages: the rank's row.  The protection
of the zone is then

  * syndrome plane k (k = 0 .. r-1): XOR over ranks i of g^(k.i) * row_i,
    products in GF(2^32) modulo x^32 + x^22 + x^2 + x + 1, g = x; rank i
    stores segment i of every plane;
  * per page of `bw` words (Fletcher-64 over u32 words, modulo 2^32):
    A = sum w_j, B = sum (bw - j) w_j;
  * per rank, the same two sums over its whole row (the row digest).

Everything is int32 bit patterns in torch (u32 arithmetic runs in int64
and is masked back).  The functions take an explicit device and work rank
by rank, so that a gigabyte zone fits beside nothing else.
"""
from __future__ import annotations

import torch

MASK = (1 << 32) - 1
POLY = 0x400007


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> int32 bit patterns."""
    x = x & MASK
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def words_of(x: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as little-endian int32 words, the last one
    zero-padded."""
    b = x.contiguous().reshape(-1).view(torch.uint8)
    pad = (-b.numel()) % 4
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    return b.view(torch.int32)


# -- the zone's layout --------------------------------------------------------

def rank_shard(leaf: torch.Tensor, spec, coords: dict, sizes: dict):
    """The block of a global leaf that the rank at mesh coordinates
    `coords` (axis name -> index; `sizes` axis name -> size) holds: `spec`
    names, for each leading dimension of the leaf, the mesh axis (or axes,
    major first) it is split over in equal blocks, or None."""
    out = leaf
    for dim, axes in enumerate(spec or ()):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx, n = 0, 1
        for a in axes:
            idx, n = idx * sizes[a] + coords[a], n * sizes[a]
        block = out.shape[dim] // n
        out = out.narrow(dim, idx * block, block)
    return out


def row_words(words: int, ranks: int, bw: int) -> int:
    """A row of `words` payload words padded to a whole number of G
    pages."""
    unit = ranks * bw
    return -(-words // unit) * unit


def rank_row(state: dict, specs: dict, coords: dict, sizes: dict,
             n_words: int = None) -> torch.Tensor:
    """The padded word row of the rank at `coords` (sorted key order)."""
    parts = [words_of(rank_shard(state[k], specs[k], coords, sizes))
             for k in sorted(state)]
    row = torch.cat(parts)
    n_words = row.numel() if n_words is None else n_words
    return torch.cat([row, row.new_zeros(n_words - row.numel())])


# -- GF(2^32) -----------------------------------------------------------------

def xtime_int(x: int) -> int:
    x &= MASK
    return ((x << 1) & MASK) ^ (POLY if x >> 31 else 0)


def pow_g(e: int) -> int:
    out = 1
    for _ in range(e):
        out = xtime_int(out)
    return out


def gf_mul_const(x: torch.Tensor, c: int) -> torch.Tensor:
    """Carry-less product of int32 words by the constant `c`, reduced
    modulo POLY: shift and add, one bit of c at a time."""
    c &= MASK
    acc = torch.zeros_like(x)
    a = x.clone()
    poly = torch.tensor(POLY, dtype=torch.int32, device=x.device)
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    while c:
        if c & 1:
            acc ^= a
        c >>= 1
        if c:
            a = (a << 1) ^ torch.where(a < 0, poly, zero)
    return acc


# -- Fletcher-64 --------------------------------------------------------------

def fletcher_pages(row: torch.Tensor, bw: int) -> torch.Tensor:
    """(A, B) of each page of `bw` words: `(n,)` -> `(n / bw, 2)` int32."""
    w = row.reshape(-1, bw).to(torch.int64) & MASK
    weights = torch.arange(bw, 0, -1, device=row.device, dtype=torch.int64)
    a = w.sum(-1)
    b = (w * weights).sum(-1)
    return to_i32(torch.stack([a, b], -1))


def row_digest(row: torch.Tensor, chunk: int = 1 << 22) -> torch.Tensor:
    """(A, B) over the whole row of n words: B weights word j by n - j."""
    n = row.numel()
    a = b = 0
    for s in range(0, n, chunk):
        w = row[s:s + chunk].to(torch.int64) & MASK
        j = torch.arange(s, s + w.numel(), device=row.device,
                         dtype=torch.int64)
        a = (a + int(w.sum())) & MASK
        b = (b + int((((n - j) & MASK) * w & MASK).sum())) & MASK
    return to_i32(torch.tensor([a, b], dtype=torch.int64))


# -- the whole zone -----------------------------------------------------------

class Zone:
    """The protection a zone must hold for a global `state`, each leaf
    placed on a mesh of `sizes` (axis name -> size, in mesh order; the
    zone runs along "data") by its `specs` entry: rows, syndrome stacks,
    Fletcher tables and row digests, built rank by rank on `device`."""

    def __init__(self, state: dict, specs: dict, *, sizes: dict, bw: int,
                 r: int, device):
        self.state, self.specs, self.device = state, specs, device
        self.sizes, self.bw, self.r = dict(sizes), bw, r
        self.ranks = self.sizes["data"]
        self.others = [a for a in self.sizes if a != "data"]
        first = self.coords(0, 0)
        payload = sum(
            words_of(rank_shard(v, specs[k], first, self.sizes)).numel()
            for k, v in state.items())
        self.row_words = row_words(payload, self.ranks, bw)

    def columns(self) -> int:
        """Zones: the product of the non-data axes."""
        n = 1
        for a in self.others:
            n *= self.sizes[a]
        return n

    def coords(self, rank: int, column: int) -> dict:
        """Mesh coordinates of data rank `rank` in zone `column`."""
        out = {"data": rank}
        for a in reversed(self.others):
            out[a] = column % self.sizes[a]
            column //= self.sizes[a]
        return out

    def index(self, rank: int, column: int) -> tuple:
        """The rank's index into a zone-stacked `(*mesh, ...)` tensor."""
        c = self.coords(rank, column)
        return tuple(c[a] for a in self.sizes)

    def row(self, rank: int, column: int = 0) -> torch.Tensor:
        return rank_row(self.state, self.specs, self.coords(rank, column),
                        self.sizes, self.row_words).to(self.device)

    def planes(self, column: int = 0) -> torch.Tensor:
        """`(r, row_words)` syndrome planes of one zone, folded rank by
        rank."""
        out = torch.zeros(self.r, self.row_words, dtype=torch.int32,
                          device=self.device)
        for i in range(self.ranks):
            row = self.row(i, column)
            for k in range(self.r):
                out[k] ^= gf_mul_const(row, pow_g(k * i)) if k else row
        return out

    def segment(self, planes: torch.Tensor, rank: int) -> torch.Tensor:
        """The `(r, seg)` part of the planes that data rank `rank` holds."""
        seg = self.row_words // self.ranks
        return planes[:, rank * seg:(rank + 1) * seg]


def compare(z: Zone, got: dict) -> dict:
    """Words and terms where the program's zone-stacked `row`, `synd`
    (`(*mesh, r, seg)`), `cksums` and `digest` differ from the zone's."""
    off = {"row_words_off": 0, "stack_words_off": 0, "table_terms_off": 0,
           "digest_terms_off": 0}
    for col in range(z.columns()):
        planes = z.planes(col)
        for i in range(z.ranks):
            at = z.index(i, col)
            row = z.row(i, col)
            off["row_words_off"] += int((got["row"][at] != row).sum())
            off["stack_words_off"] += int(
                (got["synd"][at] != z.segment(planes, i)).sum())
            off["table_terms_off"] += int(
                (got["cksums"][at] != fletcher_pages(row, z.bw)).sum())
            off["digest_terms_off"] += int(
                (got["digest"][at] != row_digest(row).to(z.device)).sum())
    return off
