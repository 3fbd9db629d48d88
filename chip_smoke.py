"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

1. Card and build: the card's name and power limit; both CUDA kernels
   built from src/repro_torch/kernels/csrc/ (one nvcc per source, in
   parallel), with the build time.
2. Kernels against their plain PyTorch versions on the card, byte for
   byte: each of the six entry points at the main path's shape — 100
   ranks x 2600 pages of 1024 words, with `stored` corrupted on a few
   pages — and at edge shapes (1 page, 13 pages, 64-word pages); then each
   timed with CUDA events (median of 12 runs after warm-up) beside its
   plain version and its least time on the card.
3. The main path at the pool size of Pangolin's headline figure: a zone of
   G = 100 data ranks holding about 1.065 GB of rows (2600 pages a rank),
   so the parity is about 1% of the pool.  Through `Pool`, with random
   weights from a seed: open (mlpc, r = 1), a bulk transaction with
   verify, a bulk commit, 16-page patches with and without verify, the
   same patch on an mlp pool, rank loss + recover, scribble + scrub +
   repair, canary abort.  After each phase the invariants are recomputed
   with the plain versions: synd = XOR fold of the rows, cksums = Fletcher
   terms of the rows, digest = combine(cksums), row = flatten(state).
4. The kernel launches of the main path (every count zeroed just before
   it, read just after); each of the six entry points must have run.
5. Peak device memory of the main path.

Every phase raises on failure.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
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
G, PAGES, BW = 100, 2600, 1024
LOST, SCRIBBLED = 37, 5        # the ranks phases f and g damage
SEED = 0

KERNELS = {   # entry point: (CUDA source, TPU kernel replaced, int ops/word)
    "fletcher_blocks": ("src/repro_torch/kernels/csrc/fletcher.cu",
                        "src/repro/kernels/fletcher.py:38", 3),
    "fletcher_stream": ("src/repro_torch/kernels/csrc/fletcher.cu",
                        "src/repro/kernels/fletcher.py:82", 3),
    "fused_commit": ("src/repro_torch/kernels/csrc/commit_fused.cu",
                     "src/repro/kernels/commit_fused.py:83", 4),
    "fused_verify_commit": ("src/repro_torch/kernels/csrc/commit_fused.cu",
                            "src/repro/kernels/commit_fused.py:103", 7),
    "fused_commit_old_terms": ("src/repro_torch/kernels/csrc/commit_fused.cu",
                               "src/repro/kernels/commit_fused.py:103", 7),
    "fused_verify_commit_stream": (
        "src/repro_torch/kernels/csrc/commit_fused.cu",
        "src/repro/kernels/commit_fused.py:393", 7),
}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# -- 2. kernels against their plain versions ---------------------------------

def entry_calls(ops, fl, cf, old, new, stored):
    """{name: (kernel call, plain call)}; each returns a tuple of tensors."""
    zeros = torch.zeros_like(stored)

    def bad(t):
        return (t != 0).any(-1)
    return {
        "fletcher_blocks": (lambda: (ops.fletcher_blocks(new),),
                            lambda: (fl.fletcher_pages_plain(new),)),
        "fletcher_stream": (lambda: ops.fletcher_stream(new),
                            lambda: fl.fletcher_stream_plain(new)),
        "fused_commit": (lambda: ops.fused_commit(old, new),
                         lambda: cf.commit_pages_plain(old, new)[:2]),
        "fused_verify_commit": (
            lambda: ops.fused_verify_commit(old, new, stored),
            lambda: (lambda d, t, m, _: (d, t, bad(m)))(
                *cf.commit_pages_plain(old, new, stored))),
        "fused_commit_old_terms": (
            lambda: ops.fused_commit_old_terms(old, new),
            lambda: cf.commit_pages_plain(old, new, zeros)[:3]),
        "fused_verify_commit_stream": (
            lambda: ops.fused_verify_commit_stream(old, new, stored),
            lambda: (lambda d, t, m, g: (d, t, bad(m), g))(
                *cf.commit_pages_plain(old, new, stored, digest=True))),
    }


def io_bytes(name, n_pages, ranks):
    """Bytes the function must move: each input read once, each output
    written once (terms 8 B a page, bad 1 B a page, digest 8 B a rank)."""
    page = BW * 4
    reads = {"fletcher_blocks": n_pages * page,
             "fletcher_stream": n_pages * page}.get(name, 2 * n_pages * page)
    writes = n_pages * 8                                  # new terms
    if name.startswith("fused"):
        writes += n_pages * page                          # delta
    if "verify" in name:
        reads += n_pages * 8                              # stored terms
        writes += n_pages                                 # bad
    if name == "fused_commit_old_terms":
        writes += n_pages * 8                             # old terms
    if name.endswith("stream"):
        writes += ranks * 8                               # digest
    return reads + writes


def max_abs_err(got, want):
    err = 0
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


def kernels_vs_plain(dev):
    from repro_torch.kernels import commit_fused as cf
    from repro_torch.kernels import fletcher as fl
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def pages(shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    shapes = [(G, 1, PAGES, BW), (G, 1, 16, BW), (1, BW), (13, BW),
              (3, 13, 64)]
    timing = {}
    for shape in shapes:
        old, new = pages(shape), pages(shape)
        stored = fl.fletcher_pages_plain(old)
        stored[..., ::997, 1] ^= 1                 # a few corrupted pages
        calls = entry_calls(ops, fl, cf, old, new, stored)
        for name, (kernel, plain) in calls.items():
            got = kernel()
            torch.cuda.synchronize()
            err = max_abs_err(got, plain())
            check(err == 0, f"{name} at {shape}: kernel != plain (err {err})")
            if shape == shapes[0]:
                n_pages = old.numel() // BW
                nbytes = io_bytes(name, n_pages, G)
                ops_n = KERNELS[name][2] * old.numel()
                bound_b = nbytes / HBM_BYTES_PER_S * 1e3
                bound_o = ops_n / INT32_OPS_PER_S * 1e3
                timing[name] = dict(
                    shape=list(shape), bytes=nbytes, max_abs_err=err,
                    kernel_ms=cuda_ms(kernel), plain_ms=cuda_ms(plain, runs=5),
                    bound_ms=max(bound_b, bound_o),
                    bound_by="bytes" if bound_b >= bound_o else "operations")
        del old, new, stored, calls
        torch.cuda.empty_cache()
        emit(phase="kernels_vs_plain", shape=list(shape), equal=True)
    return timing


# -- 3. the main path --------------------------------------------------------

def invariants(pool, tag):
    """Recompute the protection with the plain versions and compare."""
    from repro_torch.core import checksum, layout
    from repro_torch.kernels.fletcher import fletcher_pages_plain
    prot, lo, mode = pool.prot, pool.protector.layout, pool.mode
    rows = layout.flatten_row(lo, prot.state)
    check(torch.equal(rows, prot.row), f"{tag}: row cache != flatten(state)")
    if mode.has_parity:
        # XOR of the G rows, one rank at a time (no code shared with the
        # engine's folds); rank i holds segment i of it
        dd = pool.mesh.data_dim
        fold = functools.reduce(torch.bitwise_xor, rows.unbind(dd))
        segs = fold.reshape(*fold.shape[:-1], G, -1).movedim(-2, dd)
        check(torch.equal(prot.synd[..., 0, :], segs),
              f"{tag}: synd != fold of rows")
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


def main_path(dev):
    from repro_torch import Fault, Pool, ProtectConfig
    from repro_torch.kernels import _build
    from repro_torch.runtime import failure

    mesh, specs, state = zone_state(dev)

    def launched(before):
        return {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                if v - before.get(k, 0)}

    def phase(tag, fn, pool=None):
        """Time `fn` (host clock, synchronized), then check the invariants
        of `pool` — or of the pool `fn` returns."""
        before = dict(_build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        invariants(out if pool is None else pool, tag)
        emit(phase=tag, ms=ms, launches=launched(before))
        return out, launched(before)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()

    pool, _ = phase("a_open_mlpc", lambda: Pool.open(
        state, specs, mesh=mesh, device=dev,
        config=ProtectConfig(mode="mlpc")))
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
    cur, l_b = phase("b_bulk_verify", bulk_verify, pool)
    check(l_b.get("fused_verify_commit_stream") == 1, f"b launches {l_b}")

    def bulk():
        new = bumped(cur)
        check(bool(pool.commit(new, data_cursor=2)), "bulk commit failed")
        return new
    cur, l_c = phase("c_bulk", bulk, pool)
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
    cur, l_d = phase("d_patch_16_pages", patches, pool)
    check(l_d.get("fused_verify_commit") == 1 and
          l_d.get("fused_commit") == 1, f"d launches {l_d}")
    check(pool.step == 4, f"step {pool.step}")

    def mlp_patch():
        mlp = Pool.open(cur, specs, mesh=mesh, device=dev,
                        config=ProtectConfig(mode="mlp"))
        check(bool(mlp.commit(bumped(cur, words=patch), dirty_pages=dirty)),
              "mlp patch failed")
        return mlp
    mlp, l_e = phase("e_mlp_patch", mlp_patch)
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
    phase("f_rank_loss_recover", rank_loss, pool)
    check(torch.equal(pool.prot.row, before_loss), "f: rows differ")

    def scribble():
        pool.prot, _ = failure.inject_scribble(
            pool.protector, pool.prot, rank=SCRIBBLED, word_offsets=[12345])
        report = pool.scrub()
        check(report.bad_locations == [(SCRIBBLED, 12)], f"scrub {report}")
        check(report.repaired and report.repair_ok, f"repair {report}")
    phase("g_scribble_scrub_repair", scribble, pool)
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
    phase("h_canary_abort", canary_abort, pool)

    counts = dict(_build.LAUNCHES)
    return counts, torch.cuda.max_memory_allocated(dev)


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
    counts, peak = main_path(dev)
    missing = [k for k in ops.ENTRY_POINTS if not counts.get(k)]
    check(not missing, f"entry points never launched on the main path: "
          f"{missing}")
    emit(phase="memory", max_memory_allocated=peak)
    for name in ops.ENTRY_POINTS:
        t = timing[name]
        emit(name=name, shape=t["shape"], bytes=t["bytes"],
             kernel_ms=t["kernel_ms"], plain_ms=t["plain_ms"],
             bound_ms=t["bound_ms"], library_ms=None, launches=counts[name])
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=KERNELS[name][0],
        replaces=KERNELS[name][1], launches=counts[name],
        max_abs_err=timing[name]["max_abs_err"], ms=timing[name]["kernel_ms"],
        plain_ms=timing[name]["plain_ms"], bound_ms=timing[name]["bound_ms"],
        bound_by=timing[name]["bound_by"], library_ms=None)
        for name in ops.ENTRY_POINTS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
