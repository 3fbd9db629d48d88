"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

1. Card and build: the card's name and power limit; the four CUDA
   libraries built from src/repro_torch/kernels/csrc/ (one nvcc per
   source, in parallel), with the build time.
2. Kernels against their plain PyTorch versions on the card, byte for
   byte: each of the nineteen entry points at the main path's shape — 100
   ranks x 2600 pages of 1024 words, with `stored` corrupted on a few
   pages, the syndrome sweeps at r = 3 — at the 16-page patch shape, and at
   edge shapes (1 page, 13 pages, 64-word pages; the syndrome sweeps at
   r = 2 and r = 4); the XOR kernel also on 1-D runs whose length is not a
   multiple of 4 and on slices that are not 16-byte aligned; the
   weight_words kernel (gf_scale, sdelta_stack) at r = 1..4 on leads 1, 3
   and 100, rows from 4 words to a block's share ± 4 words, and
   coefficients 0 and 1; the page-run sweeps (`syndrome_edges`: the five
   syndrome_pages entry points at r = 2..4; `fletcher_edges`: both
   fletcher_pages entry points) on leads 1, 3 and 100 of 1, K - 1, K,
   K + 1, 16 and 2600 pages (K the pages a CTA takes) of 4 and 1024
   words, the coefficient tables holding 0 and 1; commit_pages
   (`commit_edges`: its nine entry points, fused_accum_commit_tb the
   ninth) on the same shapes.  Then each timed at the
   main path's shape with CUDA events: one launch with its enqueue
   (`kernel_ms`, median of 12 runs after warm-up) and the device time of
   20 back-to-back launches enqueued behind a spin kernel (`device_ms`;
   operands under 100 MB cycle through a ring of input sets larger than
   twice the L2; a kernel and its library call in turns, k, lib, lib, k),
   beside its plain version, the one PyTorch call that computes the same
   function where there is one (`torch.bitwise_xor` for the XOR kernel),
   its least time on the card (by bytes, and by the integer operations of
   the byte-table GF multiply), the integer-op time of the 32-step
   multiply and, for the table multiply that every GF kernel runs, the
   time of its shared-memory lookups.  A device time under 95% of its
   bound fails the run.  `xor_delta` and `sdelta_stack` also at the patch
   flush's shape (100 ranks x 34 pages), with the host µs a call of
   `xor_delta` and `torch.bitwise_xor`; the three row-10 syndrome sweeps
   and the rows 3-4 sweeps (fused_commit, fused_verify_commit,
   fused_commit_old_terms) at the 16-page patch's shape (100 ranks x 16
   pages, r = 3 for the syndrome sweeps), L2-cold.
3. The r = 1 main path at the pool size of Pangolin's headline figure: a
   zone of G = 100 data ranks holding about 1.065 GB of rows (2600 pages a
   rank), so the parity is about 1% of the pool.  Through `Pool`, with
   random weights from a seed: open (mlpc, r = 1), a bulk transaction with
   verify, a bulk commit, 16-page patches with and without verify, the
   same patch on an mlp pool, rank loss + recover, scribble + scrub +
   repair, canary abort.
4. The r = 3 main path on the same zone: open (mlpc, redundancy 3), a bulk
   transaction with verify (streamed), a bulk commit, 16-page patches with
   and without verify, the patch on an mlp r = 3 pool, the pre-check, the
   loss of ranks 5, 37 and 99 at once recovered by `Fault.multi_loss`
   (the rebuilt rows must equal a copy taken before the loss), a scrub.
5. The deferred-epoch engine (window > 1) on the same zone:
   w3 — the bulk engine, streamed, mlpc r = 3, window 4: open, three
        in-window commits, the fourth (the boundary flush), a commit, a
        canary abort mid-window, a commit, the loss of ranks 5, 37 and 99
        recovered by `Fault.multi_loss` (the recovery flushes first), a
        scrub;
   w1f — the bulk engine on the flat kernel (stream threshold 1<<22),
        mlpc r = 1, window 4: open, four commits;
   wp — the patch engine, mlp r = 3, window 8, the w_tp leaf dirty: open,
        eight commits of w_tp (one names its words), the eighth the
        boundary flush.
   Every boundary is compared byte for byte with a synchronous pool given
   the same states (its commits run outside the clock and its launches
   are not counted).
6. The async commit ring and tenancy on the same zone:
   q3 — the synchronous engine, mlpc r = 3, pipeline_depth 4: a warm-up
        (a verified, a staged-abort and a patch commit), eight bulk
        commit_async (the third with verify_old, the fifth with a staged
        canary from a smashed guard buffer, `tx.canary_device()`), poll
        and drain, sixteen 16-page patches, the loss of ranks 5, 37 and
        99 with three tickets in flight (the recovery drains first);
   qw — the w3 engine at depth 4: eight commit_async, the third a staged
        abort mid-window;
   tg — a PoolGroup of four tenants of the main path's state in one
        cohort (mlpc r = 3, sync engine): admission, a bulk wave, a
        verify_old wave, a wave where t2's canary fails, the same bulk
        wave looped (`batched=False`), two waves through commit_async at
        depth 2, a scrub_tick under a two-pool page budget, and t1's
        recovery from the loss of ranks 5, 37 and 99 beside a wave of the
        other three;
   tw — the same group at window 4: four waves, the fourth the flush.
   q3 and qw are compared at every drained boundary with a pool that
   resolves each commit before the next (its walls reported beside,
   its launches not counted), every tg / tw wave with four solo pools
   replayed on the same states outside the clock.  Every dispatch into a
   ring that is not full runs under torch.cuda.set_sync_debug_mode(
   "error"); each batched wave must launch each of its kernels once.
7. Elastic rescale, straggler mitigation and the chaos campaign:
   el — on the same zone, a synchronous mlpc r = 3 pool: commit, rescale
        to a 50 x 2 mesh, commit, rescale to 100 x 1, commit; the same on
        a w3-style pool (window 4, streamed) with a commit pending in the
        window at each rescale (the flush is on the clock).  After each
        rescale the invariants at the new G, the same bytes as a pool
        freshly opened on the new mesh, the step carried.  A window-8
        pool (straggler_threshold 2.0, window_growth_commits 4) fed commit
        times with rank 37 at 6x: rank 37 dropped, the window at 1, the
        health degraded; healed, the window regrows.  A PoolGroup of two
        tenants rescaled 100 x 1 -> 50 x 2, each tenant against a solo
        pool rescaled the same way;
   ch — the chaos workload's initial state and traffic step on the card
        against the host form and the CPU (a sample); then every scenario
        of the quick campaign and its first two storm cells, (1, 1) and
        (2, 16), at full width: 1,064,960,000 bytes a workload (a quarter
        of that for each of multi_tenant_interference's eight live
        tenants) on the reference's meshes scaled up, (4, 2) -> 50 x 2 and
        (8, 1) -> 100 x 1, traced in memory.  Each must end golden-exact
        with no trace violation; each prints its commit p50 / p99 clean
        and during a disturbance, its recovery and rescale ms, the window
        trace, its peak memory and its launches.
8. After each phase the invariants are recomputed apart from the engine:
   every syndrome plane k = XOR over ranks i of g^(k·i)·row_i, built rank by
   rank with the plain GF multiply; cksums = Fletcher terms of the rows;
   digest = combine(cksums); row = flatten(state).  Inside a window: the
   checksums and digest are the live rows'; the stack is the epoch start's;
   the bulk engine's accumulator is row_start ^ row_now, and the patch
   engine's row is pinned at the epoch start.
9. Each path's kernel launches (every count zeroed just before the path,
   read just after); every entry point of the path must have run.  Peak
   device memory of each path; the host ms of each async dispatch.

Every phase raises on failure.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import collections
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM: 3.35 TB/s of HBM; int32 ALU ops at 64 lanes per SM per clock
# (the 67 TFLOP/s fp32 peak is 128 lanes, an FMA counted as two) =
# 132 SMs * 64 * 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# shared-memory lookups: 32 lanes an SM a clock (128 B a clock, 4 B a lane)
LDS_LANES_PER_S = 132 * 32 * 1.98e9
L2_BYTES = 50e6
DEVICE_LAUNCHES = 20           # back-to-back launches a device_ms reading
SPIN_CYCLES = 4_000_000        # ~2 ms at 1.98 GHz: the host's head start
HOST_CALLS = 1000              # enqueues a host_us reading
G, PAGES, BW = 100, 2600, 1024
R = 3                          # the redundancy of the r >= 2 main path
LOST, SCRIBBLED = 37, 5        # the ranks the r = 1 path damages
MULTI_LOST = (5, 37, 99)       # the ranks the r = 3 path loses at once
WP_PAGES = 33                  # w_tp's pages a rank, the wp path's dirty set
FLUSH_SLOTS = WP_PAGES + 1     # pages its flush gathers (+ one fill slot)
SEED = 0

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


# The cost of the 32-step multiply, reported beside the bound and not a
# bound: 32 steps of acc ^= cur & bit mask; cur = (cur << 1) ^ (sign mask &
# POLY).  Compiled into a sweep it forms the doubling chain cur = x·g^i
# once a word for every plane (2 ALU instructions a step: SHF for the sign
# mask, LOP3 for the xor; the shift left issues on the FMA pipe) and adds
# one LOP3 a step for each weighted plane (scripts/torch_sass_counts.py).
# No kernel runs it on the words any more: weight_words (gf_scale,
# sdelta_stack) and syndrome_pages ran it until they took the table
# multiply, and it is the floor the table design has to beat.
def clmul_ops(planes):
    return 32 * (2 + planes) if planes else 0



def no_gf(r):
    return 0


def weighted(r):
    return r - 1


CUDA = "src/repro_torch/kernels/csrc/"
KERNELS = {   # entry point: (CUDA source, TPU kernel replaced, ops a word
    #                besides the GF multiply, weighted planes(r))
    "fletcher_blocks": (CUDA + "fletcher.cu",
                        "src/repro/kernels/fletcher.py:38", 3, no_gf),
    "fletcher_stream": (CUDA + "fletcher.cu",
                        "src/repro/kernels/fletcher.py:82", 3, no_gf),
    "fused_commit": (CUDA + "commit_fused.cu",
                     "src/repro/kernels/commit_fused.py:83", 4, no_gf),
    "fused_verify_commit": (CUDA + "commit_fused.cu",
                            "src/repro/kernels/commit_fused.py:103", 7,
                            no_gf),
    "fused_commit_old_terms": (CUDA + "commit_fused.cu",
                               "src/repro/kernels/commit_fused.py:103", 7,
                               no_gf),
    "fused_verify_commit_stream": (CUDA + "commit_fused.cu",
                                   "src/repro/kernels/commit_fused.py:393",
                                   7, no_gf),
    "fused_commit_stream": (CUDA + "commit_fused.cu",
                            "src/repro/kernels/commit_fused.py:377", 4,
                            no_gf),
    "fused_commit_old_terms_stream": (CUDA + "commit_fused.cu",
                                      "src/repro/kernels/commit_fused.py:393",
                                      7, no_gf),
    "gf_scale": (CUDA + "gf_parity.cu", "src/repro/kernels/gf_parity.py:83",
                 0, lambda r: 1),
    "sdelta_stack": (CUDA + "gf_parity.cu",
                     "src/repro/kernels/gf_parity.py:224", 0, weighted),
    "fused_commit_s": (CUDA + "gf_parity.cu",
                       "src/repro/kernels/gf_parity.py:151", 4, weighted),
    "fused_verify_commit_s": (CUDA + "gf_parity.cu",
                              "src/repro/kernels/gf_parity.py:151", 7,
                              weighted),
    "fused_commit_old_terms_s": (CUDA + "gf_parity.cu",
                                 "src/repro/kernels/gf_parity.py:151", 7,
                                 weighted),
    "fused_commit_s_stream": (CUDA + "gf_parity.cu",
                              "src/repro/kernels/gf_parity.py:311", 4,
                              weighted),
    "fused_verify_commit_s_stream": (CUDA + "gf_parity.cu",
                                     "src/repro/kernels/gf_parity.py:311", 7,
                                     weighted),
    # acc ^ old ^ new (2) + the Fletcher terms of old and of new (3 + 3)
    "fused_accum_commit": (CUDA + "commit_fused.cu",
                           "src/repro/kernels/commit_fused.py:185", 8,
                           no_gf),
    "fused_accum_commit_stream": (CUDA + "commit_fused.cu",
                                  "src/repro/kernels/commit_fused.py:436", 8,
                                  no_gf),
    "xor_delta": (CUDA + "xor_parity.cu", "src/repro/kernels/xor_parity.py:41",
                  1, no_gf),
    "xor_accum": (CUDA + "xor_parity.cu", "src/repro/kernels/xor_parity.py:41",
                  1, no_gf),
}
# the one PyTorch call that computes the same function, where there is one
# (timed beside the kernel as its yardstick; the port never calls it)
LIBRARY = {"xor_delta": torch.bitwise_xor, "xor_accum": torch.bitwise_xor}
# the entry points each main path must launch
PATH_R1 = ("fletcher_blocks", "fletcher_stream", "fused_commit",
           "fused_verify_commit", "fused_commit_old_terms",
           "fused_verify_commit_stream")
PATH_R3 = ("gf_scale", "sdelta_stack", "fused_commit_s",
           "fused_verify_commit_s", "fused_commit_old_terms_s",
           "fused_verify_commit_s_stream")
PATH_W3 = ("fused_accum_commit_stream", "sdelta_stack", "fletcher_blocks",
           "gf_scale")
PATH_W1F = ("fused_accum_commit", "fletcher_blocks")
PATH_WP = ("xor_delta", "sdelta_stack", "fletcher_blocks")
PATH_Q3 = ("fletcher_stream", "sdelta_stack", "fused_verify_commit_s_stream",
           "fused_commit_s", "fletcher_blocks", "gf_scale")
PATH_QW = ("fused_accum_commit_stream", "sdelta_stack")
PATH_TG = ("fletcher_blocks", "sdelta_stack", "fused_verify_commit_s",
           "fletcher_stream", "gf_scale")
PATH_TW = ("fused_accum_commit", "sdelta_stack")
PATH_EL = ("fletcher_blocks", "fletcher_stream", "sdelta_stack",
           "fused_accum_commit_stream")
PATH_CH = ("fletcher_blocks", "fletcher_stream", "sdelta_stack",
           "fused_accum_commit_stream", "gf_scale")
TENANTS = 4                    # the tenancy paths' cohort
# the entry points of the page-run sweeps: syndrome_pages, fletcher_pages
SYNDROME = ("fused_commit_s", "fused_verify_commit_s",
            "fused_commit_old_terms_s", "fused_commit_s_stream",
            "fused_verify_commit_s_stream")
FLETCHER = ("fletcher_blocks", "fletcher_stream")
# the entry points of commit_pages (the commit_edges phase adds the
# tenant-batched fused_accum_commit_tb, a ninth way into the kernel)
COMMIT = ("fused_commit", "fused_verify_commit", "fused_commit_old_terms",
          "fused_verify_commit_stream", "fused_commit_stream",
          "fused_commit_old_terms_stream", "fused_accum_commit",
          "fused_accum_commit_stream")
# the entry points that take the syndrome coefficients (checked at each r)
WITH_R = ("gf_scale", "sdelta_stack") + SYNDROME
# The table multiply's shared-memory lookups a word a weighted plane (one
# per 4-bit chunk, gf.cuh): every GF entry point's kernel runs it.
TABLE_LOOKUPS = {name: 8 for name in WITH_R}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# -- 2. kernels against their plain versions ---------------------------------

def entry_calls(old, new, stored, coeffs, scale_x):
    """{name: (kernel call, plain call)}; each returns a tuple of tensors.
    Pages `(*lead, n, bw)`; `coeffs` the `(*lead, r)` table of the
    syndrome entry points (r >= 2); `scale_x` the words gf_scale takes.
    The accumulate sweeps take ~old as the epoch accumulator."""
    from repro_torch.kernels import commit_fused as cf
    from repro_torch.kernels import fletcher as fl
    from repro_torch.kernels import gf_parity as gfk
    from repro_torch.kernels import ops
    from repro_torch.kernels import xor_parity as xp
    zeros = torch.zeros_like(stored)
    acc = torch.bitwise_not(old)
    rows = new.reshape(*new.shape[:-2], -1)
    c_last = int(coeffs.reshape(-1)[-1]) & 0xFFFFFFFF

    def bad(t):
        return (t != 0).any(-1)

    def s_plain(st=None, digest=False, keep=(0, 1, 2, 3)):
        out = gfk.syndrome_pages_plain(old, new, coeffs, st, digest)
        out = (out[0], out[1], bad(out[2]) if st is stored else out[2],
               out[3])
        return tuple(out[i] for i in keep)
    return {
        "fletcher_blocks": (lambda: (ops.fletcher_blocks(new),),
                            lambda: (fl.fletcher_pages_plain(new),)),
        "fletcher_stream": (lambda: ops.fletcher_stream(new),
                            lambda: fl.fletcher_stream_plain(new)),
        "fused_commit": (lambda: ops.fused_commit(old, new),
                         lambda: cf.commit_pages_plain(old, new)[:2]),
        "fused_verify_commit": (
            lambda: ops.fused_verify_commit(old, new, stored),
            lambda: cf.commit_pages_plain(old, new, stored)[:3]),
        "fused_commit_old_terms": (
            lambda: ops.fused_commit_old_terms(old, new),
            lambda: cf.commit_pages_plain(old, new, old_terms=True)[:3]),
        "fused_verify_commit_stream": (
            lambda: ops.fused_verify_commit_stream(old, new, stored),
            lambda: cf.commit_pages_plain(old, new, stored, digest=True)),
        "fused_commit_stream": (
            lambda: ops.fused_commit_stream(old, new),
            lambda: (lambda d, t, _, g: (d, t, g))(
                *cf.commit_pages_plain(old, new, digest=True))),
        "fused_commit_old_terms_stream": (
            lambda: ops.fused_commit_old_terms_stream(old, new),
            lambda: cf.commit_pages_plain(old, new, old_terms=True,
                                          digest=True)),
        "gf_scale": (lambda: (ops.gf_scale(scale_x, c_last),),
                     lambda: (gfk.gf_scale_plain(scale_x, c_last),)),
        "sdelta_stack": (lambda: (ops.syndrome_scale(rows, coeffs),),
                         lambda: (gfk.sdelta_stack_plain(rows, coeffs),)),
        "fused_commit_s": (lambda: ops.fused_commit_s(old, new, coeffs),
                           lambda: s_plain(keep=(0, 1))),
        "fused_verify_commit_s": (
            lambda: ops.fused_verify_commit_s(old, new, stored, coeffs),
            lambda: s_plain(stored, keep=(0, 1, 2))),
        "fused_commit_old_terms_s": (
            lambda: ops.fused_commit_old_terms_s(old, new, coeffs),
            lambda: s_plain(zeros, keep=(0, 1, 2))),
        "fused_commit_s_stream": (
            lambda: ops.fused_commit_s_stream(old, new, coeffs),
            lambda: s_plain(digest=True, keep=(0, 1, 3))),
        "fused_verify_commit_s_stream": (
            lambda: ops.fused_verify_commit_s_stream(old, new, stored,
                                                     coeffs),
            lambda: s_plain(stored, digest=True)),
        # the reference's order: (acc', old terms, new terms[, digest])
        "fused_accum_commit": (
            lambda: ops.fused_accum_commit(acc, old, new),
            lambda: (lambda a, t, m, _: (a, m, t))(
                *cf.commit_pages_plain(old, new, acc=acc))),
        "fused_accum_commit_stream": (
            lambda: ops.fused_accum_commit_stream(acc, old, new),
            lambda: (lambda a, t, m, g: (a, m, t, g))(
                *cf.commit_pages_plain(old, new, digest=True, acc=acc))),
        "xor_delta": (lambda: (ops.xor_delta(old, new),),
                      lambda: (xp.xor_words_plain(old, new),)),
        "xor_accum": (lambda: (ops.xor_accum(new, old),),
                      lambda: (xp.xor_words_plain(new, old),)),
    }


def io_bytes(name, n_pages, ranks, r, scale_words):
    """Bytes the function must move: each input read once, each output
    written once (terms 8 B a page, bad 1 B a page, digest 8 B a rank, the
    coefficient table 4 B a rank a plane)."""
    page = BW * 4
    if name == "gf_scale":
        return 2 * scale_words * 4
    if name.startswith("xor"):
        return 3 * n_pages * page                         # a, b, out
    if "accum" in name:
        # acc, old, new read; acc' written; old and new terms written
        return (4 * n_pages * page + 2 * n_pages * 8
                + (ranks * 8 if name.endswith("stream") else 0))
    if name == "sdelta_stack":
        return n_pages * page * (1 + r) + ranks * r * 4
    syndrome = name.endswith("_s") or name.endswith("_s_stream")
    reads = n_pages * page * (1 if name.startswith("fletcher") else 2)
    writes = n_pages * 8                                  # new terms
    if name.startswith("fused"):
        writes += n_pages * page * (r if syndrome else 1)  # delta planes
    if syndrome:
        reads += ranks * r * 4                            # coefficients
    if "verify" in name:
        reads += n_pages * 8                              # stored terms
        writes += n_pages                                 # bad
    if "old_terms" in name:
        writes += n_pages * 8                             # old terms
    if name.endswith("stream"):
        writes += ranks * 8                               # digest
    return reads + writes


def max_abs_err(got, want):
    err = 0
    check(len(got) == len(want), f"{len(got)} outputs vs {len(want)}")
    for a, b in zip(got, want):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"output {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} "
              f"{b.dtype}")
        if a.dtype == torch.bool:
            err = max(err, int((a != b).sum()))
        else:
            err = max(err, int(((a.to(torch.int64) & 0xFFFFFFFF)
                                - (b.to(torch.int64) & 0xFFFFFFFF))
                               .abs().max()) if a.numel() else 0)
    return err


def cuda_ms(fn, runs=12, warm=2):
    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ring_size(input_bytes, call_bytes):
    """Distinct input sets a timed run cycles through so that it reads from
    HBM and not from the 50 MB L2: one where a call's operands exceed twice
    the L2, else enough that the inputs alone do."""
    if call_bytes >= 2 * L2_BYTES:
        return 1
    return int(2 * L2_BYTES // input_bytes) + 2


def device_ms(fns, launches=DEVICE_LAUNCHES, warm=2):
    """Device ms of one call: CUDA events around `launches` back-to-back
    calls, cycling through `fns` (one per input set), over the count, after
    warm-up.  The calls are enqueued behind a spin kernel, so the events
    bracket the device's work and not the host's enqueue; the last
    len(fns) results are held, so the outputs cycle through distinct
    buffers as the inputs do."""
    held = collections.deque(maxlen=len(fns))
    for i in range(warm * len(fns)):
        held.append(fns[i % len(fns)]())
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(launches):
        held.append(fns[i % len(fns)]())
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def turns(fns, lib_fns):
    """device_ms of a kernel's calls and of the library's, timed in turns
    (kernel, library, library, kernel), each the mean of its two."""
    k0, l0, l1, k1 = (device_ms(fns), device_ms(lib_fns), device_ms(lib_fns),
                      device_ms(fns))
    return (k0 + k1) / 2, (l0 + l1) / 2


def host_us(fn, calls=HOST_CALLS):
    """Host µs a call: `calls` enqueues and one synchronize, after warm-up.
    Given a shape whose kernel takes less than its enqueue, the host's
    path is what this times."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def check_device_ms(what, ms, bound_ms):
    """A device time under 95% of the bound would be over 105% of the
    card's peak: the byte count or the cache set-up is wrong."""
    check(ms >= 0.95 * bound_ms, f"{what}: device {ms:.4f} ms under 95% of "
          f"its bound {bound_ms:.4f} ms")


def coeff_table(lead, r, dev):
    """Each leading index's syndrome coefficients: ranks of a G = 100 zone
    (the main path's own table for (G, 1) leads, else its last ranks)."""
    from repro_torch import ZoneMesh
    from repro_torch.core import gf
    if tuple(lead) == (G, 1):
        return gf.rank_syndrome_coeffs(G, r, ZoneMesh((G, 1), ("data", "m")),
                                       dev)
    n = 1
    for d in lead:
        n *= d
    table = torch.from_numpy(gf.syndrome_array(G, r)[G - n:].view("int32"))
    return table.reshape(*lead, r).to(dev)


def kernels_vs_plain(dev):
    from repro_torch.kernels import ops
    from repro_torch.kernels.fletcher import fletcher_pages_plain
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def pages(shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    seg = PAGES * BW // G
    # (page shape, the syndrome sweeps' r values); the first is the main
    # path's full-row shape, the second its 16-page patch
    shapes = [((G, 1, PAGES, BW), (R,)), ((G, 1, 16, BW), (R,)),
              ((1, BW), (2, 4)), ((13, BW), (2, 4)), ((3, 13, 64), (2, 4))]
    timing = {}
    for shape, rs in shapes:
        old, new = pages(shape), pages(shape)
        stored = fletcher_pages_plain(old)
        stored[..., ::997, 1] ^= 1                 # a few corrupted pages
        main = shape == shapes[0][0]
        # gf_scale takes one (G, 1, seg) deficit plane on the main path
        scale_x = (new.reshape(G, 1, -1)[..., :seg].contiguous() if main
                   else new)
        for i, r in enumerate(rs):
            coeffs = coeff_table(shape[:-2], r, dev)
            calls = entry_calls(old, new, stored, coeffs, scale_x)
            for name, (kernel, plain) in calls.items():
                if i and name not in WITH_R:
                    continue                   # r-free: checked once
                got = kernel()
                torch.cuda.synchronize()
                err = max_abs_err(got, plain())
                check(err == 0, f"{name} at {shape}, r = {r}: kernel != "
                      f"plain (err {err})")
                if main:
                    n_pages = old.numel() // BW
                    nbytes = io_bytes(name, n_pages, G, r, scale_x.numel())
                    words = (scale_x.numel() if name == "gf_scale"
                             else old.numel())
                    base, planes = KERNELS[name][2], KERNELS[name][3](r)
                    ops_n = (base + GF_TABLE_OPS * planes) * words
                    algo_n = (base + clmul_ops(planes)) * words
                    bound_b = nbytes / HBM_BYTES_PER_S * 1e3
                    bound_o = ops_n / INT32_OPS_PER_S * 1e3
                    bound = max(bound_b, bound_o)
                    fns = [kernel]
                    if name == "gf_scale":      # 21 MB a call: a ring
                        c = int(coeffs.reshape(-1)[-1]) & 0xFFFFFFFF
                        sets = ring_size(scale_x.numel() * 4, nbytes)
                        fns = [functools.partial(ops.gf_scale, x, c) for x in
                               [scale_x] + [pages(scale_x.shape)
                                            for _ in range(sets - 1)]]
                    library = LIBRARY.get(name)
                    lib_dev_ms = None
                    if library is None:
                        dev_ms = device_ms(fns)
                    else:                       # in turns: k, lib, lib, k
                        dev_ms, lib_dev_ms = turns(fns, [
                            functools.partial(library, old, new)])
                        check_device_ms(f"{name} library", lib_dev_ms, bound)
                    del fns
                    check_device_ms(name, dev_ms, bound)
                    lookups = TABLE_LOOKUPS.get(name, 0) * planes * words
                    timing[name] = dict(
                        shape=list(scale_x.shape if name == "gf_scale"
                                   else shape),
                        r=r if name in WITH_R else None, bytes=nbytes,
                        int_ops=ops_n, max_abs_err=err,
                        clmul_ops_ms=algo_n / INT32_OPS_PER_S * 1e3,
                        table_lds_ms=(lookups / LDS_LANES_PER_S * 1e3
                                      if lookups else None),
                        kernel_ms=cuda_ms(kernel), device_ms=dev_ms,
                        plain_ms=cuda_ms(plain, runs=5),
                        library_ms=(None if library is None else
                                    cuda_ms(lambda: library(old, new))),
                        library_device_ms=lib_dev_ms,
                        bound_bytes_ms=bound_b, bound_ops_ms=bound_o,
                        bound_ms=bound,
                        bound_by="bytes" if bound_b >= bound_o
                        else "operations")
            del calls, coeffs
        del old, new, stored, scale_x
        torch.cuda.empty_cache()
        emit(phase="kernels_vs_plain", shape=list(shape), r=list(rs),
             equal=True)
    xor_edges(pages)
    weight_edges(pages, dev)
    run_edges(pages, dev)
    commit_edges(pages, dev)
    at_flush_shape(pages, dev)
    at_patch_shape(pages, dev)
    return timing


def xor_edges(pages):
    """The XOR kernel on what pages never give it: 1-D runs whose length is
    not a multiple of 4 (its scalar tail), slices that start off a 16-byte
    boundary (its scalar path)."""
    from repro_torch.kernels import ops
    a, b = pages((8195,)), pages((8195,))
    for x, y in ((a[:1001], b[:1001]), (a[:7], b[:7]), (a[1:4097], b[2:4098]),
                 (a[3:8195], b[:8192]), (a[1:], b[:-1])):
        for fn in (ops.xor_delta, ops.xor_accum):
            got = fn(x, y)
            torch.cuda.synchronize()
            check(torch.equal(got, x ^ y), f"{fn.__name__} at {x.numel()} "
                  f"words, offsets {x.storage_offset()}/{y.storage_offset()}"
                  ": kernel != plain")
    emit(phase="xor_edges", equal=True)


def weight_edge_cases():
    """(r, lead, m) of the weight_words edge checks: r = 1 (gf_scale) to 4
    (sdelta_stack); leads 1, 3 and G; m from one uint4 to a block's least
    share of words ± 4; and one main-path row (2600 pages) at lead 1."""
    from repro_torch.kernels.gf_parity import SHARE_WORDS
    ms = (4, 1020, SHARE_WORDS - 4, SHARE_WORDS, SHARE_WORDS + 4)
    return ([(r, lead, m) for r in (1, 2, 3, 4) for lead in (1, 3, G)
             for m in ms] + [(r, 1, PAGES * BW) for r in (1, 2, 3, 4)])


def weight_case(pages, dev, r, lead, m):
    """One edge case's [(kernel call, plain call)]: at r >= 2 sdelta_stack
    with a coefficient table holding 0 (rank 0, plane 1) and 1 (the last
    rank's last plane); at r = 1 gf_scale by 0, 1 and a rank coefficient."""
    from repro_torch.kernels import gf_parity as gfk
    from repro_torch.kernels import ops
    x = pages((lead, m))
    if r == 1:
        c_big = int(coeff_table((1,), 4, "cpu")[0, -1]) & 0xFFFFFFFF
        return [(functools.partial(ops.gf_scale, x, c),
                 functools.partial(gfk.gf_scale_plain, x, c))
                for c in (0, 1, c_big)]
    coeffs = coeff_table((lead,), r, dev).clone()
    coeffs[0, 1] = 0
    coeffs[-1, -1] = 1
    return [(functools.partial(ops.syndrome_scale, x, coeffs),
             functools.partial(gfk.sdelta_stack_plain, x, coeffs))]


def weight_edges(pages, dev):
    """weight_words at every edge case, byte-equal to its plain version."""
    cases = weight_edge_cases()
    for r, lead, m in cases:
        for kernel, plain in weight_case(pages, dev, r, lead, m):
            got = kernel()
            torch.cuda.synchronize()
            check(torch.equal(got, plain()), f"weight_words at r = {r}, "
                  f"lead {lead}, m {m}: kernel != plain")
    emit(phase="weight_edges", cases=len(cases), equal=True)


def run_edge_cases():
    """(r, lead, n, bw) of the page-run edge checks: r = 2..4 (the
    syndrome sweeps; fletcher_pages takes none, so checked at r = 2 only);
    leads 1, 3 and G; n pages a rank around the K a CTA takes (1, K - 1,
    K, K + 1), the patch's 16 and a main-path rank's 2600; pages of one
    uint4 and of 1024 words."""
    from repro_torch.kernels.fletcher import RUN_PAGES as K
    ns = sorted({1, K - 1, K, K + 1, 16, PAGES})
    return [(r, lead, n, bw) for r in (2, 3, 4) for lead in (1, 3, G)
            for n in ns for bw in (4, BW)]


def run_case(pages, dev, r, lead, n, bw):
    """One edge case's [(entry point, kernel call, plain call)]: the five
    syndrome_pages entry points at r, with a coefficient table holding 0
    (rank 0, plane 1) and 1 (the last rank's last plane), and `stored`
    corrupted on every third page; at r = 2 also both fletcher_pages
    entry points."""
    from repro_torch.kernels.fletcher import fletcher_pages_plain
    old, new = pages((lead, n, bw)), pages((lead, n, bw))
    stored = fletcher_pages_plain(old)
    stored[:, ::3, 0] ^= 1
    coeffs = coeff_table((lead,), r, dev).clone()
    coeffs[0, 1] = 0
    coeffs[-1, -1] = 1
    calls = entry_calls(old, new, stored, coeffs, new)
    names = SYNDROME + (FLETCHER if r == 2 else ())
    return [(name, *calls[name]) for name in names]


def run_edges(pages, dev):
    """syndrome_pages (`syndrome_edges`) and fletcher_pages
    (`fletcher_edges`) at every page-run edge case, byte-equal to their
    plain versions."""
    cases = run_edge_cases()
    checked = collections.Counter()
    for r, lead, n, bw in cases:
        for name, kernel, plain in run_case(pages, dev, r, lead, n, bw):
            got = kernel()
            torch.cuda.synchronize()
            err = max_abs_err(got, plain())
            check(err == 0, f"{name} at r = {r}, lead {lead}, n {n}, bw "
                  f"{bw}: kernel != plain (err {err})")
            checked[name in FLETCHER] += 1
        torch.cuda.empty_cache()
    emit(phase="syndrome_edges", cases=checked[False], equal=True)
    emit(phase="fletcher_edges", cases=checked[True], equal=True)


def commit_edge_cases():
    """(lead, n, bw) of the commit_pages edge checks: the page-run edge
    cases' leads (1, 3, G), pages around the K a CTA takes (1, K - 1, K,
    K + 1), 16 and 2600, and widths (4, 1024)."""
    return sorted({(lead, n, bw) for _, lead, n, bw in run_edge_cases()})


def commit_case(pages, dev, lead, n, bw):
    """One edge case's [(entry point, kernel call, plain call)]: the eight
    commit_pages entry points, `stored` corrupted on every third page, and
    fused_accum_commit_tb with the ranks cut into TENANTS tenants where
    they divide (else one)."""
    from repro_torch.kernels import commit_fused as cf
    from repro_torch.kernels import ops
    from repro_torch.kernels.fletcher import fletcher_pages_plain
    old, new = pages((lead, n, bw)), pages((lead, n, bw))
    stored = fletcher_pages_plain(old)
    stored[:, ::3, 0] ^= 1
    # the commit entry points take no coefficients
    ones = torch.ones(lead, 2, dtype=torch.int32, device=dev)
    calls = entry_calls(old, new, stored, ones, new)
    t = TENANTS if lead % TENANTS == 0 else 1
    acc, o, nw = (x.reshape(t, lead // t, n, bw)
                  for x in (torch.bitwise_not(old), old, new))
    return [(name, *calls[name]) for name in COMMIT] + [(
        "fused_accum_commit_tb",
        functools.partial(ops.fused_accum_commit_tb, acc, o, nw),
        lambda: (lambda a, tm, om, _: (a, om, tm))(
            *cf.commit_pages_plain(o, nw, acc=acc)))]


def commit_edges(pages, dev):
    """commit_pages' nine entry points at every commit edge case,
    byte-equal to their plain versions."""
    cases = commit_edge_cases()
    for lead, n, bw in cases:
        for name, kernel, plain in commit_case(pages, dev, lead, n, bw):
            got = kernel()
            torch.cuda.synchronize()
            err = max_abs_err(got, plain())
            check(err == 0, f"{name} at lead {lead}, n {n}, bw {bw}: kernel "
                  f"!= plain (err {err})")
        torch.cuda.empty_cache()
    emit(phase="commit_edges", cases=len(cases), entry_points=len(COMMIT) + 1,
         equal=True)


def at_flush_shape(pages, dev):
    """xor_delta and sdelta_stack (r = 3) at the wp path's flush shape —
    G ranks x 34 pages, 41.8 MB for the XOR — where a call's work is tens of
    µs and the host's enqueue is of the same order: one launch timed with
    its enqueue (kernel_ms), the device time of back-to-back launches over
    a ring of input sets (device_ms), and the host µs a call of the entry
    point and of torch.bitwise_xor at one page."""
    from repro_torch.kernels import gf_parity as gfk
    from repro_torch.kernels import ops
    shape = (G, 1, FLUSH_SLOTS, BW)
    words = G * FLUSH_SLOTS * BW
    nbytes = 3 * words * 4
    sets = [(pages(shape), pages(shape))
            for _ in range(ring_size(2 * words * 4, nbytes))]
    old, new = sets[0]
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    one = pages((1, BW)), pages((1, BW))
    dev_ms, lib_dev_ms = turns(
        [functools.partial(ops.xor_delta, a, b) for a, b in sets],
        [functools.partial(torch.bitwise_xor, a, b) for a, b in sets])
    row = dict(
        phase="xor_delta_at_flush_shape", shape=list(shape), bytes=nbytes,
        ring=len(sets), kernel_ms=cuda_ms(lambda: ops.xor_delta(old, new)),
        device_ms=dev_ms, plain_ms=cuda_ms(lambda: old ^ new, runs=5),
        library_ms=cuda_ms(lambda: torch.bitwise_xor(old, new)),
        library_device_ms=lib_dev_ms,
        host_us=host_us(lambda: ops.xor_delta(*one)),
        library_host_us=host_us(lambda: torch.bitwise_xor(*one)),
        bound_ms=bound, bound_by="bytes")
    emit(**row)
    check_device_ms("xor_delta at the flush shape", row["device_ms"], bound)
    check_device_ms("torch.bitwise_xor at the flush shape",
                    row["library_device_ms"], bound)
    del sets, old, new

    xs = [pages((G, 1, FLUSH_SLOTS * BW))]
    coeffs = coeff_table((G, 1), R, dev)
    nbytes = words * 4 * (1 + R) + G * R * 4
    xs += [pages(xs[0].shape)
           for _ in range(ring_size(words * 4, nbytes) - 1)]
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    row = dict(
        phase="sdelta_stack_at_flush_shape", shape=list(xs[0].shape), r=R,
        bytes=nbytes, ring=len(xs),
        kernel_ms=cuda_ms(lambda: ops.syndrome_scale(xs[0], coeffs)),
        device_ms=device_ms([functools.partial(ops.syndrome_scale, x, coeffs)
                             for x in xs]),
        plain_ms=cuda_ms(lambda: gfk.sdelta_stack_plain(xs[0], coeffs),
                         runs=5),
        library_ms=None, bound_ms=bound, bound_by="bytes")
    emit(**row)
    check_device_ms("sdelta_stack at the flush shape", row["device_ms"], bound)


def at_patch_shape(pages, dev):
    """The row-10 syndrome sweeps (fused_commit_s, fused_verify_commit_s,
    fused_commit_old_terms_s) at the 16-page patch's shape, G ranks x 16
    pages at r = 3, as the r3 path's phases D and E run them, and the
    rows 3-4 sweeps (fused_commit, fused_verify_commit,
    fused_commit_old_terms) at the same shape, as the r1 path's phases d
    and e run them: one launch with its enqueue (kernel_ms) and the device
    time of back-to-back launches over an L2-cold ring of input sets
    (device_ms)."""
    from repro_torch.kernels import commit_fused as cf
    from repro_torch.kernels import gf_parity as gfk
    from repro_torch.kernels import ops
    from repro_torch.kernels.fletcher import fletcher_pages_plain
    shape = (G, 1, 16, BW)
    n_pages = G * 16
    coeffs = coeff_table((G, 1), R, dev)
    sets = []
    page_bytes = n_pages * BW * 4
    for _ in range(ring_size(2 * page_bytes, 5 * page_bytes)):
        old, new = pages(shape), pages(shape)
        sets.append((old, new, fletcher_pages_plain(old)))
    calls = {
        "fused_commit_s": (lambda o, n, s: ops.fused_commit_s(o, n, coeffs),
                           lambda o, n, s: gfk.syndrome_pages_plain(
                               o, n, coeffs)),
        "fused_verify_commit_s": (
            lambda o, n, s: ops.fused_verify_commit_s(o, n, s, coeffs),
            lambda o, n, s: gfk.syndrome_pages_plain(o, n, coeffs, s)),
        "fused_commit_old_terms_s": (
            lambda o, n, s: ops.fused_commit_old_terms_s(o, n, coeffs),
            lambda o, n, s: gfk.syndrome_pages_plain(
                o, n, coeffs, torch.zeros_like(s))),
        "fused_commit": (lambda o, n, s: ops.fused_commit(o, n),
                         lambda o, n, s: cf.commit_pages_plain(o, n)),
        "fused_verify_commit": (
            lambda o, n, s: ops.fused_verify_commit(o, n, s),
            lambda o, n, s: cf.commit_pages_plain(o, n, s)),
        "fused_commit_old_terms": (
            lambda o, n, s: ops.fused_commit_old_terms(o, n),
            lambda o, n, s: cf.commit_pages_plain(o, n, old_terms=True))}
    for name, (kernel, plain) in calls.items():
        nbytes = io_bytes(name, n_pages, G, R, 0)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        syndrome = name.endswith("_s")
        row = dict(
            phase=("syndrome" if syndrome else "commit") + "_at_patch_shape",
            name=name, shape=list(shape), r=R if syndrome else 1,
            bytes=nbytes, ring=len(sets),
            kernel_ms=cuda_ms(functools.partial(kernel, *sets[0])),
            device_ms=device_ms([functools.partial(kernel, *st)
                                 for st in sets]),
            plain_ms=cuda_ms(functools.partial(plain, *sets[0]), runs=5),
            library_ms=None, bound_ms=bound, bound_by="bytes")
        emit(**row)
        check_device_ms(f"{name} at the patch shape", row["device_ms"], bound)
    del sets


# -- 3.-5. the main paths ----------------------------------------------------

def invariants(pool, tag):
    """Recompute the protection apart from the engine and compare: each
    syndrome plane k is the XOR over ranks i of g^(k·i)·row_i, folded rank
    by rank with the plain GF multiply (no code shared with the engine's
    folds or kernels); rank i holds segment i of every plane."""
    from repro_torch.core import checksum, gf, layout
    from repro_torch.kernels.fletcher import fletcher_pages_plain
    prot, lo, mode = pool.prot, pool.protector.layout, pool.mode
    rows = layout.flatten_row(lo, prot.state)
    check(torch.equal(rows, prot.row), f"{tag}: row cache != flatten(state)")
    if mode.has_parity:
        dd = pool.mesh.data_dim
        for k in range(pool.redundancy):
            fold = functools.reduce(torch.bitwise_xor, (
                gf.mul_const(row_i, gf.pow_g_int(k * i)) if k else row_i
                for i, row_i in enumerate(rows.unbind(dd))))
            segs = fold.reshape(*fold.shape[:-1], pool.protector.group_size,
                                -1).movedim(-2, dd)
            check(torch.equal(prot.synd[..., k, :], segs),
                  f"{tag}: syndrome plane {k} != weighted fold of rows")
    terms = fletcher_pages_plain(rows.reshape(*rows.shape[:-1], -1, BW))
    if mode.has_cksums:
        check(torch.equal(prot.cksums, terms), f"{tag}: cksums != terms")
    check(torch.equal(prot.digest, checksum.combine(terms, BW)),
          f"{tag}: digest != combine(terms)")


def zone_state(dev):
    """The main path's zone: the quickstart's three kinds of leaf at
    G = 100 ranks of 2600 pages, random from SEED."""
    from repro_torch import P, ZoneMesh
    mesh = ZoneMesh((G, 1), ("data", "model"))
    specs = {"w_fsdp": P("data", "model"), "w_tp": P(None, "model"),
             "scale": P()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state = {
        "w_fsdp": torch.randn(G * 2560, BW, device=dev, generator=gen),
        "w_tp": torch.randn(64, BW, device=dev, generator=gen).to(
            torch.bfloat16),
        "scale": torch.ones((), device=dev),
    }
    return mesh, specs, state


def bumped(st, words=None):
    """A new state: every leaf changed (bulk), or w_fsdp + 1 on the given
    slice of each rank's local words only (patch)."""
    w = st["w_fsdp"].clone()
    if words is None:
        w += 1.0
        return {"w_fsdp": w, "w_tp": (st["w_tp"] * 2).to(torch.bfloat16),
                "scale": st["scale"] + 1}
    w.view(G, -1)[:, words] += 1.0        # rank r's shard is row block r
    return {"w_fsdp": w, "w_tp": st["w_tp"], "scale": st["scale"]}


def patch_pages(lo):
    """16 whole pages of w_fsdp, pages 100..115 of every rank's row (the
    leaf starts at its slot's offset, after the sorted-first `scale`):
    (slice of each rank's local w_fsdp words, dirty page list)."""
    from repro_torch.core import layout
    slot = lo.slots[layout.leaves_for_pages(lo, [100])[0]]
    start = 100 * BW - slot.offset
    dirty = [int(p) for p in layout.range_pages(lo, slot.offset + start,
                                                 16 * BW)]
    check(dirty == list(range(100, 116)), f"dirty pages {dirty}")
    return slice(start, start + 16 * BW), dirty


class PathRun:
    """One main path's run: its launch counts from zero, its phase lines
    (host ms around the phase, synchronized, then the invariants), and
    its peak device memory."""

    def __init__(self, dev, tag):
        from repro_torch.kernels import _build
        self.build, self.dev, self.tag = _build, dev, tag
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()

    def phase(self, tag, fn, pool=None, inv=None):
        """Time `fn`, then check the invariants (`inv`, by default the
        synchronous ones) of `pool` — or of the pool `fn` returns.  Returns
        (fn's result, the phase's launches)."""
        before = dict(self.build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = {k: v - before.get(k, 0)
                    for k, v in self.build.LAUNCHES.items()
                    if v - before.get(k, 0)}
        (inv or invariants)(out if pool is None else pool, tag)
        emit(path=self.tag, phase=tag, ms=ms, launches=launched)
        return out, launched

    def aside(self, fn):
        """Run `fn` (a comparison, not the path) with its launches
        uncounted."""
        saved = dict(self.build.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        self.build.LAUNCHES.clear()
        self.build.LAUNCHES.update(saved)
        return out

    def timed_aside(self, tag, fn):
        """`aside`, timed as a phase is (host ms ending in a synchronize):
        a comparison run whose wall is reported beside the path's."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.aside(fn)
        emit(path=self.tag, phase=tag, ms=(time.perf_counter() - t0) * 1e3,
             launches="not counted (a comparison)")
        return out

    def end(self, must_launch, peak=None):
        """Check the path's launches; print them and its peak memory (or
        `peak`, for a path that reset the peak between its phases)."""
        counts = dict(self.build.LAUNCHES)
        missing = [k for k in must_launch if not counts.get(k)]
        check(not missing, f"{self.tag}: entry points never launched on "
              f"the path: {missing}")
        if peak is None:
            peak = torch.cuda.max_memory_allocated(self.dev)
        emit(path=self.tag, phase="memory", max_memory_allocated=peak,
             launches=counts)
        return counts


def open_pool(cur, specs, mesh, dev, pool_kw=None, **cfg):
    from repro_torch import Pool, ProtectConfig
    return Pool.open(cur, specs, mesh=mesh, device=dev,
                     config=ProtectConfig(**cfg), **(pool_kw or {}))


def main_path(dev):
    """The r = 1 main path (phases a-h)."""
    from repro_torch import Fault
    from repro_torch.runtime import failure

    mesh, specs, state = zone_state(dev)
    run = PathRun(dev, "r1")
    pool, _ = run.phase("a_open_mlpc", lambda: open_pool(
        state, specs, mesh, dev, mode="mlpc"))
    rep = pool.overhead_report()
    lo = pool.protector.layout
    check(lo.row_words == PAGES * BW and lo.n_blocks == PAGES,
          f"layout: {lo.row_words} words a rank")
    check(abs(rep["parity_fraction"] - 0.01) < 1e-3, f"overhead {rep}")
    emit(phase="a_layout", row_words=lo.row_words, pages_per_rank=PAGES,
         zone_row_bytes=lo.row_words * 4 * G, ranks=G,
         parity_fraction=rep["parity_fraction"])

    cur = state

    def bulk_verify():
        new = bumped(cur)
        with pool.transaction(data_cursor=1) as tx:
            tx.stage(new, verify_old=True)
        check(tx.ok, "bulk verified transaction did not commit")
        return new
    cur, l_b = run.phase("b_bulk_verify", bulk_verify, pool)
    check(l_b.get("fused_verify_commit_stream") == 1, f"b launches {l_b}")

    def bulk():
        new = bumped(cur)
        check(bool(pool.commit(new, data_cursor=2)), "bulk commit failed")
        return new
    cur, l_c = run.phase("c_bulk", bulk, pool)
    check(l_c.get("fletcher_stream") == 1, f"c launches {l_c}")

    patch, dirty = patch_pages(lo)

    def patches():
        new = bumped(cur, words=patch)
        with pool.transaction(data_cursor=3) as tx:
            tx.stage(new, dirty_pages=dirty, verify_old=True)
        check(tx.ok, "verified patch did not commit")
        newer = bumped(new, words=patch)
        with pool.transaction(data_cursor=4) as tx:
            tx.stage(newer, dirty_pages=dirty)
        check(tx.ok, "patch did not commit")
        return newer
    cur, l_d = run.phase("d_patch_16_pages", patches, pool)
    check(l_d.get("fused_verify_commit") == 1 and
          l_d.get("fused_commit") == 1, f"d launches {l_d}")
    check(pool.step == 4, f"step {pool.step}")

    def mlp_patch():
        mlp = open_pool(cur, specs, mesh, dev, mode="mlp")
        check(bool(mlp.commit(bumped(cur, words=patch), dirty_pages=dirty)),
              "mlp patch failed")
        return mlp
    mlp, l_e = run.phase("e_mlp_patch", mlp_patch)
    check(l_e.get("fused_commit_old_terms") == 1, f"e launches {l_e}")
    del mlp
    torch.cuda.empty_cache()

    before_loss = pool.prot.row.clone()

    def rank_loss():
        pool.prot, event = failure.inject_rank_loss(pool.protector,
                                                    pool.prot, LOST)
        check(not torch.equal(pool.prot.state["w_fsdp"][LOST],
                              cur["w_fsdp"].view(G, 1, 2560, BW)[LOST]),
              "rank loss did not garble the lost rank")
        rep = pool.recover(Fault.from_event(event))
        check(rep.verified and rep.reverified, f"recovery {rep}")
    run.phase("f_rank_loss_recover", rank_loss, pool)
    check(torch.equal(pool.prot.row, before_loss), "f: rows differ")

    def scribble():
        pool.prot, _ = failure.inject_scribble(
            pool.protector, pool.prot, rank=SCRIBBLED, word_offsets=[12345])
        report = pool.scrub()
        check(report.bad_locations == [(SCRIBBLED, 12)], f"scrub {report}")
        check(report.repaired and report.repair_ok, f"repair {report}")
    run.phase("g_scribble_scrub_repair", scribble, pool)
    check(torch.equal(pool.prot.row, before_loss), "g: rows differ")
    del before_loss

    def canary_abort():
        # the redo record of an aborted commit is still written, unmarked,
        # as in the reference; the commit marks must not move
        prot = pool.prot
        fields = (prot.row, prot.synd, prot.cksums, prot.digest,
                  prot.step, prot.log.mark, prot.state["w_fsdp"])
        zeros = {k: torch.zeros_like(v) for k, v in cur.items()}
        with pool.transaction() as tx:
            tx.watch(failure.smashed_canary_buffer(4096, device=dev))
            tx.stage(zeros)
        check(tx.aborted and not tx.ok, "canary did not abort")
        now = pool.prot
        for a, b in zip(fields, (now.row, now.synd, now.cksums, now.digest,
                                 now.step, now.log.mark,
                                 now.state["w_fsdp"])):
            check(torch.equal(a, b), "an abort changed protected state")
    run.phase("h_canary_abort", canary_abort, pool)
    return run.end(PATH_R1)


def main_path_r3(dev):
    """The r = 3 main path (phases A-H) on the same zone."""
    from repro_torch import Fault
    from repro_torch.runtime import failure

    mesh, specs, cur = zone_state(dev)
    run = PathRun(dev, "r3")
    pool, l_a = run.phase("A_open_mlpc_r3", lambda: open_pool(
        cur, specs, mesh, dev, mode="mlpc", redundancy=R))
    check(pool.redundancy == R and pool.prot.synd.shape[-2] == R,
          f"stack {tuple(pool.prot.synd.shape)}")
    check(l_a.get("sdelta_stack") == 1, f"A launches {l_a}")
    emit(phase="A_layout", syndrome_fraction=pool.overhead_report()[
        "syndrome_fraction"], stack_shape=list(pool.prot.synd.shape))

    def bulk_verify():
        new = bumped(cur)
        with pool.transaction(data_cursor=1) as tx:
            tx.stage(new, verify_old=True)
        check(tx.ok, "bulk verified transaction did not commit")
        return new
    cur, l_b = run.phase("B_bulk_verify", bulk_verify, pool)
    check(l_b.get("fused_verify_commit_s_stream") == 1, f"B launches {l_b}")

    def bulk():
        new = bumped(cur)
        check(bool(pool.commit(new, data_cursor=2)), "bulk commit failed")
        return new
    cur, l_c = run.phase("C_bulk", bulk, pool)
    check(l_c.get("fletcher_stream") == 1 and l_c.get("sdelta_stack") == 1,
          f"C launches {l_c}")

    patch, dirty = patch_pages(pool.protector.layout)

    def patches():
        new = bumped(cur, words=patch)
        with pool.transaction(data_cursor=3) as tx:
            tx.stage(new, dirty_pages=dirty, verify_old=True)
        check(tx.ok, "verified patch did not commit")
        newer = bumped(new, words=patch)
        with pool.transaction(data_cursor=4) as tx:
            tx.stage(newer, dirty_pages=dirty)
        check(tx.ok, "patch did not commit")
        return newer
    cur, l_d = run.phase("D_patch_16_pages", patches, pool)
    check(l_d.get("fused_verify_commit_s") == 1 and
          l_d.get("fused_commit_s") == 1, f"D launches {l_d}")

    def mlp_patch():
        mlp = open_pool(cur, specs, mesh, dev, mode="mlp", redundancy=R)
        check(bool(mlp.commit(bumped(cur, words=patch), dirty_pages=dirty)),
              "mlp patch failed")
        return mlp
    mlp, l_e = run.phase("E_mlp_r3_patch", mlp_patch)
    check(l_e.get("fused_commit_old_terms_s") == 1, f"E launches {l_e}")
    del mlp
    torch.cuda.empty_cache()

    def precheck():
        report = pool.precheck()
        check(report.local_only and not report.suspect and
              report.synd_ok == [True] * R, f"precheck {report}")
    _, l_f = run.phase("F_precheck", precheck, pool)
    check(l_f.get("sdelta_stack") == 1, f"F launches {l_f}")

    before_loss = pool.prot.row.clone()

    def multi_loss():
        pool.prot, event = failure.inject_multi_rank_loss(
            pool.protector, pool.prot, MULTI_LOST)
        for rank in MULTI_LOST:
            check(not torch.equal(pool.prot.state["w_fsdp"][rank],
                                  cur["w_fsdp"].view(G, 1, 2560, BW)[rank]),
                  f"multi loss did not garble rank {rank}")
        rep = pool.recover(Fault.from_event(event))
        check(rep.verified and rep.reverified and rep.synd_ok == [True] * R
              and rep.lost_ranks == list(MULTI_LOST), f"recovery {rep}")
    _, l_g = run.phase("G_multi_loss_recover", multi_loss, pool)
    check(l_g.get("gf_scale", 0) >= 1, f"G launches {l_g}")
    check(torch.equal(pool.prot.row, before_loss), "G: rows differ")
    del before_loss

    def scrub():
        report = pool.scrub()
        check(not report.suspect and report.synd_ok == [True] * R,
              f"scrub {report}")
    run.phase("H_scrub", scrub, pool)
    return run.end(PATH_R3)


# -- 5. the deferred-epoch engine ---------------------------------------------

def window_invariants(start_row, start_synd):
    """The in-window invariants, apart from the engine: the checksums and
    the digest are the live rows' (the Fletcher terms, plain); the stack is
    the epoch start's; the bulk engine's row is the live rows and its
    accumulator row_start ^ row_now; the patch engine's row is pinned at
    the epoch start."""
    def inv(pool, tag):
        from repro_torch.core import checksum, layout
        from repro_torch.kernels.fletcher import fletcher_pages_plain
        prot, lo = pool.prot, pool.protector.layout
        rows = layout.flatten_row(lo, prot.state)
        terms = fletcher_pages_plain(rows.reshape(*rows.shape[:-1], -1, BW))
        if pool.mode.has_cksums:
            check(torch.equal(prot.cksums, terms), f"{tag}: cksums != terms")
        check(torch.equal(prot.digest, checksum.combine(terms, BW)),
              f"{tag}: digest != combine(terms)")
        check(torch.equal(prot.synd, start_synd), f"{tag}: stack moved")
        if pool.engine.patch:
            check(torch.equal(prot.row, start_row), f"{tag}: row moved")
        else:
            check(torch.equal(prot.row, rows), f"{tag}: row != flatten")
            check(torch.equal(pool._est.acc, start_row ^ rows),
                  f"{tag}: acc != row_start ^ row_now")
    return inv


def same_as_sync(pool, sync, path, tag):
    """A windowed pool at its epoch boundary holds exactly what the
    synchronous pool does after the same commits."""
    a, b = pool.prot, sync.prot
    for field in ("synd", "cksums", "digest", "row", "step"):
        x, y = getattr(a, field), getattr(b, field)
        check((x is None and y is None) or torch.equal(x, y),
              f"{tag}: {field} != the synchronous pool's")
    for field in ("digest", "mark", "step"):
        check(torch.equal(getattr(a.log, field), getattr(b.log, field)),
              f"{tag}: log.{field} != the synchronous pool's")
    emit(path=path, phase=tag, same_as_sync=True)


class Lockstep:
    """A windowed pool and a synchronous one fed the same states; the
    synchronous commits run outside the clock, their launches uncounted."""

    def __init__(self, run, pool, sync, cur, sync_kw=None):
        self.run, self.pool, self.sync, self.cur = run, pool, sync, cur
        self.sync_kw = sync_kw or {}
        self.since_start()

    def since_start(self):
        self.start_row = self.pool.prot.row.clone()
        self.start_synd = self.pool.prot.synd.clone()

    def commit(self, tag, new, boundary=False, **kw):
        def go():
            check(bool(self.pool.commit(new, data_cursor=self.step, **kw)),
                  f"{tag}: commit failed")
        self.step = self.pool.step + 1
        inv = None if boundary else window_invariants(self.start_row,
                                                      self.start_synd)
        _, launched = self.run.phase(tag, go, self.pool, inv)
        self.run.aside(lambda: self.sync.commit(
            new, data_cursor=self.step, **self.sync_kw))
        self.cur = new
        if boundary:
            same_as_sync(self.pool, self.sync, self.run.tag, tag)
            self.since_start()
        return launched


def window_path_w3(dev):
    """The bulk engine, streamed, at r = 3 (phases W_a-W_i)."""
    from repro_torch import Fault
    from repro_torch.runtime import failure

    mesh, specs, cur = zone_state(dev)
    cfg = dict(mode="mlpc", redundancy=R)
    run = PathRun(dev, "w3")
    pool, l_a = run.phase("W_a_open_window_4", lambda: open_pool(
        cur, specs, mesh, dev, window=4, **cfg))
    check(pool.engine.window == 4 and not pool.engine.patch and
          pool.protector.stream_chunk() is not None, "w3: engine")
    check(l_a == {"fletcher_blocks": 1, "sdelta_stack": 1},
          f"W_a launches {l_a}")
    sync = run.aside(lambda: open_pool(cur, specs, mesh, dev, **cfg))
    ls = Lockstep(run, pool, sync, cur)
    for i in (1, 2, 3):
        got = ls.commit(f"W_b_commit_{i}", bumped(ls.cur))
        check(got == {"fused_accum_commit_stream": 1},
              f"W_b commit {i} launches {got}")
    got = ls.commit("W_c_commit_4_flush", bumped(ls.cur), boundary=True)
    check(got == {"fused_accum_commit_stream": 1, "sdelta_stack": 1},
          f"W_c launches {got}")
    ls.commit("W_d_commit_5", bumped(ls.cur))

    def canary_abort():
        est = pool._est
        fields = (est.prot.row, est.prot.synd, est.prot.cksums,
                  est.prot.digest, est.prot.step, est.prot.log.mark,
                  est.acc, est.pending)
        zeros = {k: torch.zeros_like(v) for k, v in ls.cur.items()}
        with pool.transaction() as tx:
            tx.watch(failure.smashed_canary_buffer(4096, device=dev))
            tx.stage(zeros)
        check(tx.aborted and not tx.ok, "canary did not abort")
        now = pool._est
        for a, b in zip(fields, (now.prot.row, now.prot.synd,
                                 now.prot.cksums, now.prot.digest,
                                 now.prot.step, now.prot.log.mark, now.acc,
                                 now.pending)):
            check(torch.equal(a, b), "an abort changed the window")
        check(pool.engine._since == 2, "an abort is an attempt")
    _, l_e = run.phase("W_e_canary_abort_mid_window", canary_abort, pool,
                       window_invariants(ls.start_row, ls.start_synd))
    check(not l_e, f"W_e launches {l_e}")
    ls.commit("W_f_commit_6", bumped(ls.cur))
    del ls, sync
    before_loss = pool.prot.row.clone()

    def multi_loss():
        # the loss lands inside the open window: the window's bookkeeping
        # is kept, so the recovery's flush still sees the accumulator
        prot, event = failure.inject_multi_rank_loss(pool.protector,
                                                     pool.prot, MULTI_LOST)
        pool._est = dataclasses.replace(pool._est, prot=prot)
        rep = pool.recover(Fault.from_event(event))
        check(rep.verified and rep.reverified and rep.synd_ok == [True] * R
              and rep.window_bound == {"pending": 2, "dirty_pages": None,
                                       "digest_verified": True},
              f"recovery {rep}")
        check(pool.engine.window == 1, "failure suspicion: window 1")
    _, l_g = run.phase("W_g_multi_loss_recover", multi_loss, pool)
    check(l_g.get("sdelta_stack", 0) >= 2 and l_g.get("gf_scale", 0) >= 1,
          f"W_g launches {l_g}")
    check(torch.equal(pool.prot.row, before_loss), "W_g: rows differ")
    del before_loss

    def scrub():
        report = pool.scrub()
        check(not report.suspect and report.synd_ok == [True] * R,
              f"scrub {report}")
        check(pool.engine.window == 2, "a clean scrub regrows the window")
    run.phase("W_h_scrub", scrub, pool)
    return run.end(PATH_W3)


def window_path_w1f(dev):
    """The bulk engine on the flat kernel at r = 1 (phases V_a-V_c)."""
    mesh, specs, cur = zone_state(dev)
    cfg = dict(mode="mlpc", stream_threshold_words=1 << 22)
    run = PathRun(dev, "w1f")
    pool, l_a = run.phase("V_a_open_window_4", lambda: open_pool(
        cur, specs, mesh, dev, window=4, **cfg))
    check(pool.protector.stream_chunk() is None, "w1f: flat route")
    sync = run.aside(lambda: open_pool(cur, specs, mesh, dev, **cfg))
    ls = Lockstep(run, pool, sync, cur)
    for i in (1, 2, 3):
        got = ls.commit(f"V_b_commit_{i}", bumped(ls.cur))
        check(got == {"fused_accum_commit": 1}, f"V_b launches {got}")
    got = ls.commit("V_c_commit_4_flush", bumped(ls.cur), boundary=True)
    check(got == {"fused_accum_commit": 1}, f"V_c launches {got}")
    return run.end(PATH_W1F)


def window_path_wp(dev):
    """The patch engine at r = 3, mode mlp, on the w_tp leaf (phases
    P_a-P_c)."""
    from repro_torch.core import layout

    mesh, specs, cur = zone_state(dev)
    cfg = dict(mode="mlp", redundancy=R)
    run = PathRun(dev, "wp")
    pool, l_a = run.phase("P_a_open_window_8", lambda: open_pool(
        cur, specs, mesh, dev, window=8, pool_kw={"dirty_leaf_idx": [2]},
        **cfg))
    lo, eng = pool.protector.layout, pool.engine
    pages = layout.leaf_pages(lo, 2).tolist()
    check(lo.slots[2].shape == (64, BW) and len(pages) == WP_PAGES and
          eng.flush_patch and eng.flush_capacity == FLUSH_SLOTS,
          f"wp: engine {eng.flush_patch} {eng.flush_capacity}")
    sync = run.aside(lambda: open_pool(cur, specs, mesh, dev, **cfg))
    ls = Lockstep(run, pool, sync, cur, sync_kw={"dirty_pages": pages})
    n_words = lo.slots[2].n_words

    def w_tp(st, i):
        w = st["w_tp"].clone()
        w[4 * i:4 * i + 4] += 1.0          # 4 rows = 2048 words a rank
        return {"w_fsdp": st["w_fsdp"], "w_tp": w, "scale": st["scale"]}
    for i in range(1, 8):
        kw = {}
        if i == 3:                             # the changed words named,
            words = torch.arange(4 * i * BW // 2, (4 * i + 4) * BW // 2)
            kw["dirty_words"] = (torch.cat([words, torch.tensor(
                [n_words, n_words + 5000])]),)  # + indices past the leaf
        got = ls.commit(f"P_b_commit_{i}", w_tp(ls.cur, i), **kw)
        check(not got, f"P_b commit {i} launches {got}")
    got = ls.commit("P_c_commit_8_flush", w_tp(ls.cur, 8), boundary=True)
    check(got == {"xor_delta": 1, "sdelta_stack": 1}, f"P_c launches {got}")
    return run.end(PATH_WP)


# -- 6. the async commit ring and tenancy ------------------------------------

def same_prot(a, b, tag):
    """Two protected states byte for byte: every protection field, the redo
    log and the state leaves."""
    for field in ("synd", "cksums", "digest", "row", "step"):
        x, y = getattr(a, field), getattr(b, field)
        check((x is None and y is None) or torch.equal(x, y),
              f"{tag}: {field} differs")
    for field in ("step", "data_cursor", "rng", "digest", "mark"):
        check(torch.equal(getattr(a.log, field), getattr(b.log, field)),
              f"{tag}: log.{field} differs")
    for k in a.state:
        check(torch.equal(a.state[k], b.state[k]), f"{tag}: state.{k} differs")


def same_pool(pool, other, tag):
    """A pool against its comparison pool: the protected state and, with a
    window open, the accumulator and the pending count."""
    same_prot(pool.prot, other.prot, tag)
    if pool.engine is not None:
        check(torch.equal(pool._est.acc, other._est.acc) and
              torch.equal(pool._est.pending, other._est.pending) and
              pool.engine._since == other.engine._since,
              f"{tag}: open window differs")


# the caching allocator's counters that a dispatch must leave alone: a
# retry frees cached segments (a cudaFree, which syncs the device) and
# allocates again; a device alloc is a cudaMalloc of a new segment
ALLOC_COUNTS = ("num_alloc_retries", "num_device_free", "num_device_alloc")


def alloc_counts():
    stats = torch.cuda.memory_stats()
    return {k: stats.get(k, 0) for k in ALLOC_COUNTS}


class Dispatches:
    """Host ms of each commit_async (or wave) dispatch, and the allocator
    counters it moved (`alloc`, only the ones that moved).  Every dispatch
    into a ring that is not full runs under torch.cuda.set_sync_debug_mode(
    "error"): a host sync there raises and fails the run, and so does an
    allocator retry or cudaFree, which the debug mode does not see (a full
    ring resolves its oldest ticket, a sync by design)."""

    def __init__(self):
        self.ms, self.alloc, self.strict = [], [], 0

    def __call__(self, ring, fn):
        strict = len(ring) < ring.depth
        before = alloc_counts()
        if strict:
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            self.ms.append((time.perf_counter() - t0) * 1e3)
            if strict:
                torch.cuda.set_sync_debug_mode("default")
                self.strict += 1
            moved = {k: v - before[k] for k, v in alloc_counts().items()
                     if v != before[k]}
            self.alloc.append(moved)
            check(not strict or not (moved.get("num_alloc_retries")
                                     or moved.get("num_device_free")),
                  f"dispatch {len(self.ms)} into a ring not full: "
                  f"allocator {moved}")


def feed(pool, commits):
    """A comparison pool's commit_async of each (state, keywords), each
    verdict read before the next dispatch: synchronous resolution."""
    for state, kw in commits:
        pool.commit_async(state, **kw).result()
    pool.drain()


def nothing(pool, tag):
    """No invariants for a phase (its pool is compared byte for byte)."""


def async_path_q3(dev):
    """The async ring on the synchronous engine at r = 3, depth 4 (phases
    Q_a-Q_h), against a depth-1 pool fed the same states and verdicts."""
    from repro_torch import Fault
    from repro_torch.runtime import failure

    mesh, specs, cur = zone_state(dev)
    cfg = dict(mode="mlpc", redundancy=R)
    run = PathRun(dev, "q3")
    pool, _ = run.phase("Q_a_open_depth_4", lambda: open_pool(
        cur, specs, mesh, dev, pipeline_depth=4, **cfg))
    ring = pool._ring
    ref = run.aside(lambda: open_pool(cur, specs, mesh, dev,
                                      pipeline_depth=1, **cfg))
    tx = pool.transaction()
    tx.watch(failure.smashed_canary_buffer(4096, device=dev))
    canary = tx.canary_device()            # staged: read on the device
    patch, dirty = patch_pages(pool.protector.layout)
    states = [cur, bumped(cur)]
    states.append(bumped(states[-1], words=patch))
    warm = [(states[1], dict(data_cursor=1, verify_old=True)),
            (states[1], dict(data_cursor=2, canary_ok=canary)),
            (states[2], dict(data_cursor=3, dirty_pages=dirty))]

    def warm_up():
        feed(pool, warm)
    run.phase("Q_a_warm_up_first_use", warm_up, pool)
    run.timed_aside("Q_a_warm_up_depth_1", lambda: feed(ref, warm))
    same_pool(pool, ref, "Q_a")
    states = states[2:]
    for _ in range(8):
        states.append(bumped(states[-1]))
    kws = [dict(verify_old=True) if i == 2 else
           dict(canary_ok=canary) if i == 4 else {} for i in range(8)]
    disp = Dispatches()
    aborted = pool.stats()["aborted_commits"]

    def bulk():
        return [disp(ring, lambda i=i: pool.commit_async(
            states[i + 1], data_cursor=i + 1, **kws[i])) for i in range(8)]
    tickets, l_b = run.phase("Q_b_8_bulk_commit_async", bulk, inv=nothing)
    del warm
    emit(path="q3", phase="Q_b_dispatch_ms", ms=disp.ms[:8],
         alloc=disp.alloc[:8])
    check(l_b.get("fused_verify_commit_s_stream") == 1 and
          l_b.get("fletcher_stream") == 7, f"Q_b launches {l_b}")

    def poll_drain():
        polled = pool.poll()
        return len(polled), len(pool.drain())
    (polled, drained), _ = run.phase("Q_c_poll_drain", poll_drain,
                                     inv=nothing)
    verdicts = [t.result() for t in tickets]
    check(verdicts == [i != 4 for i in range(8)], f"Q_c verdicts {verdicts}")
    check(pool.stats()["aborted_commits"] == aborted + 1,
          "Q_c: the staged abort")
    emit(path="q3", phase="Q_c_polled_drained", polled=polled,
         drained=drained)
    run.timed_aside("Q_d_8_bulk_depth_1", lambda: feed(ref, [
        (states[i + 1], dict(data_cursor=i + 1, **kws[i]))
        for i in range(8)]))
    same_pool(pool, ref, "Q_d")
    invariants(pool, "Q_d")
    emit(path="q3", phase="Q_d_drained_same_as_depth_1", equal=True)
    cur = states[-1]
    del states, tickets
    patches = [cur]
    for _ in range(16):
        patches.append(bumped(patches[-1], words=patch))

    def patch_16():
        out = [disp(ring, lambda i=i: pool.commit_async(
            patches[i + 1], data_cursor=9 + i, dirty_pages=dirty))
            for i in range(16)]
        pool.drain()
        return out
    tickets, l_e = run.phase("Q_e_16_patch_depth_4", patch_16, inv=nothing)
    emit(path="q3", phase="Q_e_dispatch_ms", ms=disp.ms[8:],
         alloc=disp.alloc[8:])
    check(all(t.result() for t in tickets), "Q_e: a patch failed")
    check(l_e.get("fused_commit_s") == 16, f"Q_e launches {l_e}")
    run.timed_aside("Q_f_16_patch_depth_1", lambda: feed(ref, [
        (patches[i + 1], dict(data_cursor=9 + i, dirty_pages=dirty))
        for i in range(16)]))
    same_pool(pool, ref, "Q_f")
    emit(path="q3", phase="Q_f_drained_same_as_depth_1", equal=True)
    cur = patches[-1]
    del patches, tickets
    before = [cur]
    for _ in range(3):
        before.append(bumped(before[-1]))

    def loss_in_flight():
        burst = [disp(ring, lambda i=i: pool.commit_async(
            before[i + 1], data_cursor=25 + i)) for i in range(3)]
        check(pool.in_flight == 3, f"in flight {pool.in_flight}")
        pool.prot, event = failure.inject_multi_rank_loss(
            pool.protector, pool.prot, MULTI_LOST)
        rep = pool.recover(Fault.from_event(event))
        check(rep.verified and rep.reverified and rep.synd_ok == [True] * R
              and pool.in_flight == 0 and all(t.result() for t in burst),
              f"recovery {rep}")
    _, l_g = run.phase("Q_g_loss_with_3_in_flight", loss_in_flight,
                       inv=nothing)
    check(l_g.get("gf_scale", 0) >= 1, f"Q_g launches {l_g}")
    run.aside(lambda: feed(ref, [(before[i + 1], dict(data_cursor=25 + i))
                                 for i in range(3)]))
    same_pool(pool, ref, "Q_h")
    invariants(pool, "Q_h")
    emit(path="q3", phase="Q_h_recovered_same_as_depth_1", equal=True,
         strict_dispatches=disp.strict)
    check(disp.strict >= 4 + 4, f"strict dispatches {disp.strict}")
    return run.end(PATH_Q3)


def async_path_qw(dev):
    """The w3 configuration (bulk engine, streamed, r = 3, window 4) at
    depth 4 (phases X_a-X_e): eight commit_async, the third a staged abort
    mid-window, each boundary against the synchronous engine."""
    from repro_torch.kernels import ops

    mesh, specs, cur = zone_state(dev)
    cfg = dict(mode="mlpc", redundancy=R)
    run = PathRun(dev, "qw")
    pool, _ = run.phase("X_a_open_window_4_depth_4", lambda: open_pool(
        cur, specs, mesh, dev, window=4, pipeline_depth=4, **cfg))
    sync = run.aside(lambda: open_pool(cur, specs, mesh, dev, **cfg))
    abort = run.aside(lambda: ops.stage_verdict(
        [torch.zeros((), dtype=torch.bool, device=dev)]))
    disp, ring = Dispatches(), pool._ring
    for w, tag in ((0, "X_b"), (1, "X_d")):
        states = [cur]
        for _ in range(4):
            states.append(bumped(states[-1]))
        kws = [dict(canary_ok=abort) if (w, i) == (0, 2) else {}
               for i in range(4)]

        def window(states=states, kws=kws):
            out = [disp(ring, lambda i=i: pool.commit_async(
                states[i + 1], data_cursor=4 * w + i + 1, **kws[i]))
                for i in range(4)]
            pool.drain()
            return out
        tickets, launched = run.phase(f"{tag}_4_commit_async_drain", window,
                                      inv=nothing)
        # the staged abort runs the all-clear step too, then selects
        want = {"fused_accum_commit_stream": 4, "sdelta_stack": 1}
        check(launched == want, f"{tag} launches {launched}")
        check([t.result() for t in tickets] == [(w, i) != (0, 2)
                                                for i in range(4)],
              f"{tag} verdicts")
        check(pool.engine._since == 0, f"{tag}: not at a boundary")
        run.aside(lambda states=states, kws=kws: feed(sync, [
            (states[i + 1], dict(data_cursor=4 * w + i + 1, **kws[i]))
            for i in range(4)]))
        same_as_sync(pool, sync, "qw", f"{tag}_boundary")
        cur = states[-1]
        del states, tickets
    emit(path="qw", phase="X_dispatch_ms", ms=disp.ms, alloc=disp.alloc,
         strict_dispatches=disp.strict)
    check(disp.strict == 8, f"strict dispatches {disp.strict}")
    invariants(pool, "X_e")
    return run.end(PATH_QW)


def tenant_states(cur, n):
    """n tenants' distinct states of the main path's shapes."""
    return [{"w_fsdp": cur["w_fsdp"] + t,
             "w_tp": (cur["w_tp"] * (t + 1)).to(torch.bfloat16),
             "scale": cur["scale"] + t} for t in range(n)]


def tenancy_path(dev, tag, window):
    """A PoolGroup of T tenants of the main path's state in one cohort
    (mlpc, r = 3; `window` 1: the sync engine, 4: the bulk deferred
    engine), every wave against solo pools replayed on the same states
    outside the clock.  Returns the path's launch counts."""
    from repro_torch import Fault
    from repro_torch.runtime import failure
    from repro_torch.tenancy import PoolGroup

    mesh, specs, base = zone_state(dev)
    cfg = dict(mode="mlpc", redundancy=R, window=window)
    run = PathRun(dev, tag)
    tids = [f"t{t}" for t in range(TENANTS)]
    cur = dict(zip(tids, tenant_states(base, TENANTS)))
    del base

    def admit():
        from repro_torch import ProtectConfig
        group = PoolGroup(mesh, device=dev, pipeline_depth=2,
                          scrub_page_budget=2 * G * PAGES)
        for tid in tids:
            group.admit(tid, cur[tid], specs, config=ProtectConfig(**cfg))
        return group
    group, l_a = run.phase(f"{tag}_a_admit_{TENANTS}", admit, inv=nothing)
    check(len(group.cohorts) == 1, f"{tag}: cohorts {group.stats()}")
    solos = run.aside(lambda: {tid: open_pool(cur[tid], specs, mesh, dev,
                                              **cfg) for tid in tids})
    waves = []

    def wave(name, want=None, tenants=None, **kw):
        """One wave of bumped states: timed, its launches checked, then
        replayed on the solo pools and compared."""
        tenants = tenants or tids
        ups = {tid: bumped(cur[tid]) for tid in tenants}
        can = kw.get("canary_ok", True)
        oks, launched = run.phase(name, lambda: group.commit(ups, **kw),
                                  inv=nothing)
        check(want is None or launched == want,
              f"{name} launches {launched}, want {want}")
        waves.append((name, launched))

        def replay():
            for tid in tenants:
                c = can.get(tid, True) if isinstance(can, dict) else can
                solos[tid].commit(ups[tid], canary_ok=c,
                                  verify_old=kw.get("verify_old", False))
                check(bool(oks[tid]) == c, f"{name}: {tid} verdict")
        run.aside(replay)
        for tid in tenants:
            same_pool(group[tid].pool, solos[tid], f"{name} {tid}")
            if bool(oks[tid]):
                cur[tid] = ups[tid]
        return oks

    if window == 1:
        bulk = {"fletcher_blocks": 1, "sdelta_stack": 1}
        wave(f"{tag}_b_bulk_wave", bulk)
        wave(f"{tag}_c_verify_wave", {"fused_verify_commit_s": 1},
             verify_old=True)
        wave(f"{tag}_d_canary_fails_t2", bulk,
             canary_ok={tid: tid != "t2" for tid in tids})
        wave(f"{tag}_e_looped_wave", {"fletcher_stream": TENANTS,
                                      "sdelta_stack": TENANTS},
             batched=False)
        disp = Dispatches()
        ring = group._ring

        def async_waves():
            ups = [{tid: bumped(cur[tid]) for tid in tids}]
            ups.append({tid: bumped(ups[0][tid]) for tid in tids})
            tickets = [disp(ring, lambda u=u: group.commit_async(u))
                       for u in ups]
            group.drain()
            return ups, tickets
        (ups, tickets), l_f = run.phase(f"{tag}_f_2_waves_async_drain",
                                        async_waves, inv=nothing)
        check(l_f == {k: 2 for k in bulk} and
              all(t.result() for t in tickets), f"{tag}_f launches {l_f}")
        emit(path=tag, phase=f"{tag}_f_dispatch_ms", ms=disp.ms,
             alloc=disp.alloc, strict_dispatches=disp.strict)
        check(disp.strict == 2, f"strict dispatches {disp.strict}")
        run.aside(lambda: [solos[tid].commit(u[tid]) for u in ups
                           for tid in tids])
        for tid in tids:
            cur[tid] = ups[-1][tid]
            same_pool(group[tid].pool, solos[tid], f"{tag}_f {tid}")
        del ups, tickets

        def scrub_tick():
            served = group.scrub_tick()
            check(len(served) == 2 and not any(rep.suspect for *_, rep
                                               in served),
                  f"scrub_tick {served}")
            return [(tid, kind) for tid, kind, _ in served]
        served, _ = run.phase(f"{tag}_g_scrub_tick_2_pools", scrub_tick,
                              inv=nothing)
        emit(path=tag, phase=f"{tag}_g_served", served=served)

        def recover_beside_a_wave():
            victim = group["t1"].pool
            victim.prot, event = failure.inject_multi_rank_loss(
                victim.protector, victim.prot, MULTI_LOST)
            others = [tid for tid in tids if tid != "t1"]
            ups = {tid: bumped(cur[tid]) for tid in others}
            ticket = group.commit_async(ups)
            rep = group.recover("t1", Fault.from_event(event))
            check(rep.verified and rep.reverified and
                  group.quarantined == (), f"recovery {rep}")
            group.drain()
            check(ticket.result(), "the wave beside the recovery failed")
            return ups
        ups, l_h = run.phase(f"{tag}_h_recover_t1_beside_a_wave",
                             recover_beside_a_wave, inv=nothing)
        check(l_h.get("fletcher_blocks", 0) >= 1 and
              l_h.get("gf_scale", 0) >= 1, f"{tag}_h launches {l_h}")
        run.aside(lambda: [solos[tid].commit(ups[tid]) for tid in ups])
        for tid in tids:
            cur[tid] = ups.get(tid, cur[tid])
            same_pool(group[tid].pool, solos[tid], f"{tag}_h {tid}")
        # t1, left out of the wave, holds its own bytes, not the 4-stacks
        row = group["t1"].pool.prot.row
        check(row.untyped_storage().nbytes() == row.nbytes,
              f"{tag}_h: t1's row holds {row.untyped_storage().nbytes()} B")
    else:
        step = {"fused_accum_commit": 1}
        for i in range(1, 4):
            wave(f"{tag}_b_wave_{i}", step)
        wave(f"{tag}_c_wave_4_flush", dict(step, sdelta_stack=1))
    for tid in tids:
        invariants(group[tid].pool, f"{tag} {tid}")
    emit(path=tag, phase=f"{tag}_same_as_solo_pools", equal=True,
         tenants=TENANTS, waves=[w for w, _ in waves])
    return run.end(PATH_TG if window == 1 else PATH_TW)


# -- 7. elastic rescale, straggler mitigation and the chaos campaign ---------

EL_SHAPES = ((G // 2, 2), (G, 1))   # the rescales' meshes, 50 x 2 and 100 x 1
STRAGGLER = 37                      # the rank the straggler phase slows
CH_BYTES = G * PAGES * BW * 4       # the chaos workload: the main zone's rows
CH_TENANT_BYTES = CH_BYTES // 4     # each of multi_tenant_interference's
                                    # 8 live tenants (two groups of four)


def zone_mesh(shape):
    from repro_torch import ZoneMesh
    return ZoneMesh(shape, ("data", "model"))


def same_as_fresh(run, pool, cur, specs, cfg, tag):
    """A rescaled pool holds what a pool freshly opened on its mesh from the
    same global state holds, but for the step, which the rescale carries."""
    fresh = run.aside(lambda: open_pool(cur, specs, pool.mesh, run.dev,
                                        **cfg))
    for field in ("synd", "cksums", "digest", "row"):
        check(torch.equal(getattr(pool.prot, field),
                          getattr(fresh.prot, field)),
              f"{tag}: {field} != a fresh pool's")
    for k in pool.prot.state:
        check(torch.equal(pool.prot.state[k], fresh.prot.state[k]),
              f"{tag}: state.{k} != a fresh pool's")
    emit(path=run.tag, phase=tag, same_as_fresh_pool=True,
         ranks=pool.protector.group_size)


def rescale_walk(run, specs, cur, tag, cfg, want_rescale):
    """Open a pool of `cfg` on the main zone, then commit, rescale to 50 x 2,
    commit, rescale to 100 x 1, commit; a windowed pool holds each commit
    in its window, so each rescale flushes it first.  After each rescale:
    the invariants at the new G, the same bytes as a fresh pool, the step
    carried."""
    pool, _ = run.phase(f"L_{tag}_a_open", lambda: open_pool(
        cur, specs, zone_mesh(EL_SHAPES[1]), run.dev, **cfg))
    for i, shape in enumerate((*EL_SHAPES, None), start=1):
        new = bumped(cur)
        inv = None
        if pool.engine is not None:
            inv = window_invariants(pool.prot.row.clone(),
                                    pool.prot.synd.clone())

        def go():
            check(bool(pool.commit(new, data_cursor=i)), "commit failed")
        run.phase(f"L_{tag}_commit_{i}", go, pool, inv)
        cur = new
        if pool.engine is not None:
            check(pool.engine.needs_flush, f"{tag}: no commit pending")
        if shape is None:
            break
        target = zone_mesh(shape)
        moved, launched = run.phase(f"L_{tag}_rescale_{shape[0]}x{shape[1]}",
                                    lambda: pool.rescale(target))
        check(launched == want_rescale, f"{tag} rescale launches {launched}")
        check(moved.protector.group_size == shape[0] and moved.step == i,
              f"{tag}: G {moved.protector.group_size}, step {moved.step}")
        if moved.engine is not None:
            check(not moved.engine.needs_flush, f"{tag}: window not empty")
            window_invariants(moved.prot.row, moved.prot.synd)(
                moved, f"{tag} rescaled")
        same_as_fresh(run, moved, cur, specs, cfg, f"L_{tag}_{i}_fresh")
        pool = moved


def elastic_path(dev):
    """Rescale and straggler mitigation on the main zone (phases L_*)."""
    import numpy as np
    from repro_torch import ProtectConfig
    from repro_torch.tenancy import PoolGroup

    _, specs, cur = zone_state(dev)
    run = PathRun(dev, "el")
    init = {"fletcher_blocks": 1, "sdelta_stack": 1}
    rescale_walk(run, specs, cur, "sync", dict(mode="mlpc", redundancy=R),
                 init)
    rescale_walk(run, specs, cur, "w3",
                 dict(mode="mlpc", redundancy=R, window=4),
                 dict(init, sdelta_stack=2))       # + the flush's

    # a window-8 pool whose rank 37 runs 6x slow: dropped, the window held
    # at 1 and the pool degraded; then healed, and the window regrows
    cfg = dict(mode="mlpc", redundancy=R, window=8, straggler_threshold=2.0,
               window_growth_commits=4)
    mesh = zone_mesh(EL_SHAPES[1])
    pool, _ = run.phase("L_s_a_open_window_8", lambda: open_pool(
        cur, specs, mesh, dev, **cfg))
    check(pool.straggler.n_replicas == G and pool.engine.window == 8,
          "straggler pool")
    healthy = np.full(G, 0.01)
    slow = healthy.copy()
    slow[STRAGGLER] *= 6

    def commit():
        nonlocal cur
        cur = bumped(cur)
        check(bool(pool.commit(cur)), "commit failed")

    def drop():
        for _ in range(2):
            commit()
            pool.observe_commit_times(slow)
        check(pool.dropped_replicas == [STRAGGLER] and
              pool.engine.window == 1 and
              pool.health().status == "degraded",
              f"straggler: dropped {pool.dropped_replicas}, window "
              f"{pool.engine.window}, {pool.health().reasons}")
    run.phase("L_s_b_rank_37_slow", drop, pool)

    def heal():
        for n in range(1, 13):
            pool.observe_commit_times(healthy)
            if not pool.dropped_replicas:
                break
        check(not pool.dropped_replicas, "straggler never healed")
        for k in range(1, 9):
            commit()
            if pool.engine.window > 1:
                return {"observations": n, "commits_to_regrow": k}
        raise AssertionError("the window did not regrow")
    healed, _ = run.phase("L_s_c_heal_regrow", heal, pool)
    emit(path="el", phase="L_s_window", window=pool.engine.window,
         counters={k: pool.metrics.counter(k).value for k in (
             "pool_straggler_drop_total", "pool_straggler_heal_total")},
         **healed)
    del pool

    # PoolGroup.rescale of two full-width tenants, 100 x 1 -> 50 x 2, each
    # against a solo pool rescaled the same way
    tids = ("t0", "t1")
    states = dict(zip(tids, tenant_states(cur, 2)))
    gcfg = dict(mode="mlpc", redundancy=R)

    def admit():
        group = PoolGroup(mesh, device=dev)
        for tid in tids:
            group.admit(tid, states[tid], specs,
                        config=ProtectConfig(**gcfg))
        return group
    group, _ = run.phase("L_g_a_admit_2", admit, inv=nothing)
    target = zone_mesh(EL_SHAPES[0])
    moved, launched = run.phase("L_g_b_group_rescale",
                                lambda: group.rescale(target), inv=nothing)
    check(launched == {k: 2 for k in init}, f"L_g_b launches {launched}")
    del group
    for tid in tids:
        pool = moved[tid].pool
        check(pool.protector.group_size == EL_SHAPES[0][0], "group G")
        invariants(pool, f"L_g {tid}")
        solo = run.aside(lambda: open_pool(states[tid], specs, mesh, dev,
                                           **gcfg).rescale(target))
        same_prot(pool.prot, solo.prot, f"L_g {tid}")
        del solo
    emit(path="el", phase="L_g_same_as_solo_pools", equal=True,
         tenants=len(tids))
    return run.end(PATH_EL)


def traffic_sample(dev):
    """The chaos workload's initial state and three traffic steps made on
    the card, a sample held against the reference's host form (uint64
    numpy) and the steps on the CPU."""
    import numpy as np
    from repro_torch.chaos import workload
    n = CH_BYTES // 4
    w = workload.initial_state(n, SEED, dev)
    idx = torch.cat([torch.arange(0, n, 4099), torch.arange(n - 4096, n)])
    u = idx.numpy().astype(np.uint64)
    host = ((u * np.uint64(2654435761) + np.uint64(SEED * 97 + 1))
            % np.uint64(1000003)).astype(np.float32) / np.float32(1000.0)
    on_card = idx.to(dev)
    check(np.array_equal(w[on_card].cpu().numpy(), host),
          "initial state != the host form")
    sample = torch.from_numpy(host)
    fma_ms = []
    for t in range(3):
        c = np.float32(t % workload.PERIOD) * workload.STEP_BIAS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w = workload.fma(w, workload.GAIN, c)
        torch.cuda.synchronize()
        fma_ms.append((time.perf_counter() - t0) * 1e3)
        sample = workload.fma(sample, workload.GAIN, c)
        check(torch.equal(w[on_card].cpu(), sample),
              f"traffic step {t} on the card != the CPU's")
    return {"words": n, "sampled": int(idx.numel()), "fma_ms": fma_ms}


def chaos_path(dev):
    """Every scenario of the quick campaign and its first two storm cells
    at full width (phases C_*), each golden-exact with a valid trace."""
    from repro_torch.chaos import scenarios
    run = PathRun(dev, "ch")
    sampled, _ = run.phase("C_traffic_step_sample",
                           lambda: traffic_sample(dev), inv=nothing)
    emit(path="ch", phase="C_traffic_step_equal", **sampled)
    size = dict(quick=True, seed=SEED, meshes=EL_SHAPES, device=dev)
    jobs = [(name, functools.partial(
        scenarios.run_scenario, name, n_bytes=(
            CH_TENANT_BYTES if name == "multi_tenant_interference"
            else CH_BYTES), **size))
        for name in (*scenarios.SCENARIOS, *scenarios.GROUP_SCENARIOS)]
    jobs += [(f"storm_r{r}_w{w}", functools.partial(
        scenarios.run_storm_cell, r, w, n_bytes=CH_BYTES, **size))
        for r, w in scenarios.STORM_CELLS[:2]]
    results, peaks = [], []
    for name, job in jobs:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        out, launched = run.phase(f"C_{name}", job, inv=nothing)
        peaks.append(torch.cuda.max_memory_allocated(dev))
        results.append(out)
        emit(path="ch", phase=f"C_{name}_result",
             golden_exact=out["golden_exact"],
             trace_events=out["trace"]["events"],
             trace_violations=out["trace"]["violations"],
             commit_ms=out["commit_ms"], recovery_ms=out["recovery_ms"],
             rescale_ms=[r["ms"] for r in out["recoveries"]
                         if r["kind"] == "rescale"],
             recoveries=[{k: r[k] for k in ("kind", "ms", "verified")
                          if k in r} for r in out["recoveries"]],
             window_trace=out.get("window_trace"),
             health=out["health"]["status"],
             max_memory_allocated=peaks[-1], launches=launched)
        del out
    scenarios.check_results(results)
    return run.end(PATH_CH, peak=max(peaks))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from repro_torch.kernels import _build, ops
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    t0 = time.perf_counter()
    _build.build()
    emit(phase="build", ms=(time.perf_counter() - t0) * 1e3,
         sources=list(_build.SOURCES))

    timing = kernels_vs_plain(dev)
    paths = {"r1": main_path(dev), "r3": main_path_r3(dev),
             "w3": window_path_w3(dev), "w1f": window_path_w1f(dev),
             "wp": window_path_wp(dev), "q3": async_path_q3(dev),
             "qw": async_path_qw(dev), "tg": tenancy_path(dev, "tg", 1),
             "tw": tenancy_path(dev, "tw", 4), "el": elastic_path(dev),
             "ch": chaos_path(dev)}
    rows = []
    for name in ops.ENTRY_POINTS:
        t = timing[name]
        by_path = {p: c.get(name, 0) for p, c in paths.items()}
        emit(name=name, shape=t["shape"], r=t["r"], bytes=t["bytes"],
             int_ops=t["int_ops"], kernel_ms=t["kernel_ms"],
             device_ms=t["device_ms"], plain_ms=t["plain_ms"],
             bound_bytes_ms=t["bound_bytes_ms"],
             bound_ops_ms=t["bound_ops_ms"],
             clmul_ops_ms=t["clmul_ops_ms"], table_lds_ms=t["table_lds_ms"],
             library_ms=t["library_ms"],
             library_device_ms=t["library_device_ms"],
             launches_by_path=by_path)
        # no PyTorch call computes Fletcher terms or the GF(2^32) product:
        # library_ms is null but for the XOR kernel
        rows.append(dict(
            name=name, route="cuda", source=KERNELS[name][0],
            replaces=KERNELS[name][1], launches=sum(by_path.values()),
            max_abs_err=t["max_abs_err"], ms=t["kernel_ms"],
            device_ms=t["device_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"],
            library_device_ms=t["library_device_ms"]))
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
