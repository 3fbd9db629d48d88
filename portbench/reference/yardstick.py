"""The benchmark's frozen yardstick: peaks, the bytes and integer operations
each protection kernel must do, the least bytes a commit must move, and
the model FLOPs of an xLSTM decode step.

The kernel arithmetic is a copy of `repro_torch.kernels.cost` (`io_bytes`,
`int_ops`) as it stood when the benchmark was written, kept here so that a
later change to the program cannot move the bound it is measured against.
Every count is of what the work needs: each input read once, each output
written once, whatever the implementation reads again.
"""
from __future__ import annotations

import math

# One NVIDIA H100 SXM (data sheet, dense rates, 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# int32 ALU: 132 SMs x 64 lanes x 1.98 GHz.  Derived from the SM count and
# the boost clock, not a data-sheet figure; stated beside the bytes bound,
# which binds every protection kernel at the shapes the cells run.
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# -- the protection kernels (copy of kernels/cost.py) -------------------------

GF_TABLE_OPS = 7

BASE_OPS = {
    "fletcher_blocks": 3, "fletcher_stream": 3,
    "fused_commit": 4, "fused_commit_stream": 4,
    "fused_verify_commit": 7, "fused_commit_old_terms": 7,
    "fused_verify_commit_stream": 7, "fused_commit_old_terms_stream": 7,
    "gf_scale": 0, "sdelta_stack": 0,
    "fused_commit_s": 4, "fused_commit_s_stream": 4,
    "fused_verify_commit_s": 7, "fused_commit_old_terms_s": 7,
    "fused_verify_commit_s_stream": 7,
    "fused_accum_commit": 8, "fused_accum_commit_stream": 8,
    "xor_delta": 1, "xor_accum": 1,
}

# entry points whose operand is a flat run of words, not pages
WORD_OPERANDS = ("gf_scale", "sdelta_stack", "xor_delta", "xor_accum")


def weighted_planes(name: str, r: int) -> int:
    if name == "gf_scale":
        return 1
    if name == "sdelta_stack" or name.endswith(("_s", "_s_stream")):
        return r - 1
    return 0


def int_ops(name: str, words: int, r: int = 1) -> int:
    return (BASE_OPS[name] + GF_TABLE_OPS * weighted_planes(name, r)) * words


def io_bytes(name: str, words: int, pages: int, ranks: int,
             r: int = 1) -> int:
    if name == "gf_scale":
        return 2 * words * 4
    if name.startswith("xor"):
        return 3 * words * 4
    if "accum" in name:
        return (4 * words * 4 + 2 * pages * 8
                + (ranks * 8 if name.endswith("stream") else 0))
    if name == "sdelta_stack":
        return words * 4 * (1 + r) + ranks * r * 4
    syndrome = name.endswith(("_s", "_s_stream"))
    reads = words * 4 * (1 if name.startswith("fletcher") else 2)
    writes = pages * 8
    if name.startswith("fused"):
        writes += words * 4 * (r if syndrome else 1)
    if syndrome:
        reads += ranks * r * 4
    if "verify" in name:
        reads += pages * 8
        writes += pages
    if "old_terms" in name:
        writes += pages * 8
    if name.endswith("stream"):
        writes += ranks * 8
    return reads + writes


def launch_bound_s(name: str, shape: tuple, r: int) -> tuple:
    """(bytes, ops, least seconds, which bound binds) of one launch of the
    entry point `name` on an operand of `shape`: `(*lead, pages, bw)`, or
    `(*lead, words)` for the entry points of flat words."""
    words = math.prod(shape)
    if name in WORD_OPERANDS:
        pages, ranks = 0, math.prod(shape[:-1])
    else:
        pages, ranks = math.prod(shape[:-1]), math.prod(shape[:-2])
    nbytes = io_bytes(name, words, pages, ranks, r)
    ops = int_ops(name, words, r)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return nbytes, ops, max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "ops")


# -- a commit's least bytes ---------------------------------------------------

def commit_least_bytes(*, ranks: int, row_words: int, block_words: int,
                       r: int, state_words: int,
                       dirty_pages: int = None) -> int:
    """The bytes one synchronous commit of a zone must move, whatever
    implements it: the new state read once, the old row and the syndrome
    stack read once, and the row, the stack, the Fletcher table and the
    row digest written once.  A patch of `dirty_pages` page columns (on
    every rank) moves only those pages of the state, the row and the
    table, and their words of each syndrome plane.  `state_words` is the
    zone's payload (every rank's words of the state)."""
    n_blocks = row_words // block_words
    if dirty_pages is None:
        words_new = state_words
        words_row = ranks * row_words
        words_stack = r * row_words          # r planes, 1/G on each rank
        pages = ranks * n_blocks
    else:
        words_new = ranks * dirty_pages * block_words
        words_row = words_new
        words_stack = r * dirty_pages * block_words
        pages = ranks * dirty_pages
    reads = 4 * (words_new + words_row + words_stack)
    writes = 4 * (words_row + words_stack) + 8 * pages + 8 * ranks
    return reads + writes


# -- xLSTM model FLOPs --------------------------------------------------------

def xlstm_decode_flops(cfg: dict) -> dict:
    """Model FLOPs of one token of the served xLSTM's decode, from the
    configuration's shapes: 2 a weight for every weight that multiplies
    the token's activations, and the mLSTM's matrix-memory update
    (C += i k v^T with its decay) and read-out (C q), 2 an element each.
    Element-wise work (norms, gates, activations, the conv) and the
    sLSTM's scalar state are left out: a floor of what the step needs.
    The blocks counted are those served: q, k, v block-diagonal with one
    block a head, and no sLSTM feed-forward (arXiv:2405.04517's 1.3B model
    has blocks of 4 and that feed-forward)."""
    d, h, vocab = cfg["d_model"], cfg["n_heads"], cfg["vocab"]
    pattern = cfg["block_pattern"]
    n_m = sum(1 for i in range(cfg["n_layers"])
              if pattern[i % len(pattern)] == "mlstm")
    n_s = cfg["n_layers"] - n_m
    di = cfg["mlstm_proj_factor"] * d
    dm, ds = di // h, d // h
    # mLSTM: up (d -> 2 di), per-head q, k, v (dm x dm a head), the i / f
    # gates (di -> 2h), down (di -> d)
    m_weights = d * 2 * di + 3 * di * dm + di * 2 * h + di * d
    m_state = 2 * h * dm * dm + 2 * h * dm * dm
    # sLSTM: the four gates from the input (d -> 4d) and from h (per head
    # ds -> 4 ds), the output projection (d -> d)
    s_weights = d * 4 * d + h * ds * 4 * ds + d * d
    flops = (n_m * (2 * m_weights + m_state) + n_s * 2 * s_weights
             + 2 * d * vocab)
    return {"flops_per_token": flops, "mlstm_blocks": n_m,
            "slstm_blocks": n_s}


def share(least_s: float, measured_s: float):
    """100 x least / measured, or None where nothing was measured."""
    if not measured_s or measured_s <= 0 or not math.isfinite(measured_s):
        return None
    return 100.0 * least_s / measured_s
