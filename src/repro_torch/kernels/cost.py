"""What each protection kernel must move and compute, and the hook that
reports its launches to a cost counter.

`io_bytes` and `int_ops` reckon an entry point's work from its operands'
shapes: the bytes it must move (each input read once, each output written
once) and the integer operations it does on them.  chip_smoke.py derives
every kernel's bound from them, and the dry run (launch/cost.py) adds them
to a step's record.  The hand kernels launch through ctypes, where no
dispatch mode sees them, so each entry point of kernels/ops.py reports
itself here (`launch`), on every route — the card, the CPU's plain version
and the meta route alike; the zone collectives of dist/collectives.py
report their wire bytes (`wire`), and a split zone's processes the
bytes they exchange (`EXCHANGE`).  With no counter active both cost a
list lookup.
"""
from __future__ import annotations

import contextlib
import math

# Integer ops a word of each function, for its operation bound.  Fletcher
# (A, B) of a word: an add, a multiply, an add (3); the XOR delta adds 1.
# The GF(2^32) product by a constant c in its cheapest known form, the
# byte-table multiply: c·x = T0[x & 255] ^ T1[(x >> 8) & 255] ^ ... with
# four 256-entry tables of c·(b << 8j), so 4 lookups and 3 XORs (7) a word
# for each weighted plane (plane 0 is the raw delta, g^0 = 1).  The byte
# selects are not counted, so this is a floor.  Even timed at the shared
# memory's 32 lanes an SM a clock, the lookups of an r = 3 sweep take a
# sixth of its bytes bound: the bytes bind every GF function.
GF_TABLE_OPS = 7

# ops a word besides the GF multiply
BASE_OPS = {
    "fletcher_blocks": 3, "fletcher_stream": 3,
    "fused_commit": 4, "fused_commit_stream": 4,
    "fused_verify_commit": 7, "fused_commit_old_terms": 7,
    "fused_verify_commit_stream": 7, "fused_commit_old_terms_stream": 7,
    "gf_scale": 0, "sdelta_stack": 0,
    "fused_commit_s": 4, "fused_commit_s_stream": 4,
    "fused_verify_commit_s": 7, "fused_commit_old_terms_s": 7,
    "fused_verify_commit_s_stream": 7,
    # acc ^ old ^ new (2) + the Fletcher terms of old and of new (3 + 3)
    "fused_accum_commit": 8, "fused_accum_commit_stream": 8,
    "xor_delta": 1, "xor_accum": 1,
}


def weighted_planes(name: str, r: int) -> int:
    """The planes of a word that the GF multiply weights: gf_scale's one,
    r - 1 for the stack and the syndrome sweeps, none for the rest."""
    if name == "gf_scale":
        return 1
    if name == "sdelta_stack" or name.endswith(("_s", "_s_stream")):
        return r - 1
    return 0


def int_ops(name: str, words: int, r: int = 1) -> int:
    """Integer ops of one call over `words` words of each page operand
    (gf_scale's: the words it scales)."""
    return (BASE_OPS[name] + GF_TABLE_OPS * weighted_planes(name, r)) * words


def io_bytes(name: str, words: int, pages: int, ranks: int,
             r: int = 1) -> int:
    """Bytes one call must move: each input read once, each output written
    once (terms 8 B a page, bad 1 B a page, digest 8 B a rank, the
    coefficient table 4 B a rank a plane).  `words` the words of each page
    operand (gf_scale's: the words it scales), `pages` their pages,
    `ranks` the leading (rank) indices."""
    if name == "gf_scale":
        return 2 * words * 4
    if name.startswith("xor"):
        return 3 * words * 4                              # a, b, out
    if "accum" in name:
        # acc, old, new read; acc' written; old and new terms written
        return (4 * words * 4 + 2 * pages * 8
                + (ranks * 8 if name.endswith("stream") else 0))
    if name == "sdelta_stack":
        return words * 4 * (1 + r) + ranks * r * 4
    syndrome = name.endswith(("_s", "_s_stream"))
    reads = words * 4 * (1 if name.startswith("fletcher") else 2)
    writes = pages * 8                                    # new terms
    if name.startswith("fused"):
        writes += words * 4 * (r if syndrome else 1)      # delta planes
    if syndrome:
        reads += ranks * r * 4                            # coefficients
    if "verify" in name:
        reads += pages * 8                                # stored terms
        writes += pages                                   # bad
    if "old_terms" in name:
        writes += pages * 8                               # old terms
    if name.endswith("stream"):
        writes += ranks * 8                               # digest
    return reads + writes


# -- the active cost counter --------------------------------------------------

_COUNTERS: list = []


def push(counter) -> None:
    """Make `counter` the active one.  It takes `kernel(name, nbytes,
    int_ops)`, a context manager around the call, and `wire(kind, nbytes)`."""
    _COUNTERS.append(counter)


def pop(counter) -> None:
    if not _COUNTERS or _COUNTERS[-1] is not counter:
        raise RuntimeError("cost counters must close in the order opened")
    _COUNTERS.pop()


def launch(name: str, x, r: int = 1, pages: bool = True):
    """The context of one kernel launch on `x` (`(*lead, n, bw)` pages, or
    `(*lead, m)` words with `pages=False`): the active counter's record of
    it, or nothing."""
    if not _COUNTERS:
        return contextlib.nullcontext()
    words = x.numel()
    lead = x.shape[:-2] if pages else x.shape[:-1]
    n_pages = math.prod(x.shape[:-1]) if pages else 0
    return _COUNTERS[-1].kernel(
        name, io_bytes(name, words, n_pages, math.prod(lead), r),
        int_ops(name, words, r))


# The bytes a process of a split zone actually sent to the others
# (dist/procs.py), a kind of its own beside the reference-convention
# counts, which stay those of every rank a device.
EXCHANGE = "process-exchange"


def wire(kind: str, nbytes: float) -> None:
    """Report `nbytes` of a zone collective of `kind` (hlo_analysis's
    names: all-gather, all-reduce, reduce-scatter, all-to-all,
    collective-permute), summed over every rank of the zone-stacked
    operand; or, as `EXCHANGE`, the bytes a process sent."""
    if _COUNTERS:
        _COUNTERS[-1].wire(kind, nbytes)
