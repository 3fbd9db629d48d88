"""Time variants of the port's redesigned kernels.

    python3 scripts/torch_kernel_variants.py [--control NAME=DIR ...]
        [--only commit,syndrome,fletcher,weight,xor]

Needs one CUDA card and nvcc.  Each variant is a copy of a source in
`src/repro_torch/kernels/csrc/` with one setting changed, built in a
temporary directory (one nvcc each, all at once) and launched through its
own C launcher; each is first checked byte for byte against the plain
result.  Device ms are chip_smoke's `device_ms` (20 back-to-back launches
behind a spin kernel; operands under 100 MB over a ring of input sets
larger than twice the L2).  Prints one JSON line per kernel and shape; the
first variant of each list is the source as it stands.

* `xor_words` (xor_parity.cu): uint4 a thread (`kUnroll`), threads a
  block, the cache hints of its loads and stores (`ldg`: `__ldg` loads and
  ordinary stores, as the source has them; `cs`: the evict-first `__ldcs`
  / `__stcs`; `plain`: ordinary loads and stores) and the grid (`exact`:
  one pass of exact-sized blocks, as the source has it; `resident`: the
  blocks resident at once, striding).  Each is timed in turns with
  `torch.bitwise_xor` (variant, library, library, variant) at the main
  path's (100, 1, 2600, 1024) and the wp flush's (100, 1, 34, 1024).
* `weight_words` (gf_parity.cu) as `sdelta_stack` at r = 3: uint4 a thread
  a trip (`kWordUnroll`), trips a block (`kShare4`), a cap on the grid
  (waves of the resident blocks; one wave is the first design), and a
  register cap (least blocks an SM through `__launch_bounds__`).  Each
  also as a probe, with gf.cuh's table multiply returning the word: the
  same traffic and indexing without the lookups, the ceiling of that
  traffic (not the function, so not checked).  Each `--control NAME=DIR`
  (a checkout, such as the parent with its 32-step kernel) as it is, and
  `x.unsqueeze(-2).expand(...).contiguous()`, PyTorch's copy with the same
  traffic (one read, R plane-major writes).  Timed first to last, then
  last to first, at (100, 1, 2,662,400) and the wp flush's (100, 1, 34,816).
* `syndrome_pages` (gf_parity.cu) at r = 3 as its five entry points
  (VERIFY x DIGEST: fused_commit_s, fused_verify_commit_s and, with
  stored = 0, fused_commit_old_terms_s, fused_commit_s_stream,
  fused_verify_commit_s_stream), and `fletcher_pages` (fletcher.cu) with
  DIGEST (fletcher_stream) and without (fletcher_blocks, the ceiling of
  the DIGEST instance): pages a CTA (`kRunPages`, K), threads a CTA
  (`kRunThreads`), uint4 a lane a trip (`kLaneUnroll`) and the order of
  the CTAs (`rank`: rank-major, as pages.cuh has it; `spread`: the CTAs at
  work spread over the ranks).  Each syndrome variant also as a probe
  whose table multiply returns the word (the traffic's ceiling without
  the lookups, not checked); each `--control NAME=DIR` as it is (a
  `git archive` of the parent: its one CTA a page on the 32-step
  multiply, its atomic pair a page).  Timed first to last, then last to
  first, at the main path's (100, 1, 2600, 1024) and the 16-page patch's
  (100, 1, 16, 1024) over a ring of input sets.  `--quick` times only
  the source as it stands (and its probe) beside the controls.
* `commit_pages` (commit_fused.cu) as its eight instances (kCommit,
  kVerify, kOldTerms, kAccum, each with and without DIGEST): pages a CTA
  (`kRunPages`), threads a CTA (`kRunThreads`), uint4 a lane a trip
  (`kLaneUnroll`), a register cap (least CTAs an SM through
  `__launch_bounds__`) and the delta's stores (`st` as the source has
  them, `cs` the evict-first `__stcs`).  Each `--control NAME=DIR` is
  taken for a checkout before the page runs (its launcher's verify and
  accum flags, one CTA a page): its verify instance writes old terms ^
  stored (the verdict is left to the wrapper) and its old-terms instance
  reads a zero stored table, as that checkout's wrappers had it.  Timed
  first to last, then last to first, at the main path's (100, 1, 2600,
  1024) and the 16-page patch's (100, 1, 16, 1024) over a ring of input
  sets; each checked against the plain version first.
"""
import argparse
import ctypes
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import cost as kcost  # noqa: E402

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
# the bodies of xor_parity.cu's load(p) and store(p, v) for each hint
HINTS = {"ldg": ("return __ldg(p);", "*p = v;"),
         "cs": ("return __ldcs(p);", "__stcs(p, v);"),
         "plain": ("return *p;", "*p = v;")}
# (uint4 a thread a trip, threads a block, hints, grid)
XOR_VARIANTS = [(1, 256, "ldg", "exact"), (2, 256, "ldg", "exact"),
                (4, 256, "ldg", "exact"), (1, 128, "ldg", "exact"),
                (1, 512, "ldg", "exact"), (1, 256, "cs", "exact"),
                (4, 256, "cs", "exact"), (1, 256, "plain", "exact"),
                (1, 256, "ldg", "resident")]
# (uint4 a thread a trip, trips a block, waves of the resident blocks or
# None for no cap, least blocks an SM asked through __launch_bounds__ or
# None)
WEIGHT_VARIANTS = [(2, 2, None, None), (1, 2, None, None),
                   (4, 2, None, None), (2, 4, None, None),
                   (2, 8, None, None), (2, 2, 1, None), (2, 2, 4, None),
                   (2, 2, 16, None), (2, 2, None, 6)]
# gf.cuh's table multiply returning the word itself
PROBE = ("  const char* t = reinterpret_cast<const char*>(table);\n",
         "  return x;\n"
         "  const char* t = reinterpret_cast<const char*>(table);\n")
# (pages a CTA, threads a CTA, uint4 a lane a trip, CTA order) of the
# page-run sweeps; the first is the source as it stands
RUN_VARIANTS = [(8, 256, 8, "rank"), (16, 256, 8, "rank"),
                (4, 128, 8, "rank"), (2, 64, 8, "rank"),
                (4, 256, 8, "rank"), (16, 512, 8, "rank"),
                (8, 256, 4, "rank"), (8, 256, 8, "spread")]
# pages.cuh's page_run with the CTAs at work spread over the ranks
SPREAD = ("""  const int64_t rank = blockIdx.x / runs;
  const int first = static_cast<int>(blockIdx.x - rank * runs) * kRunPages;""",
          """  const int64_t ranks = gridDim.x / runs;
  const int64_t rank = blockIdx.x % ranks;
  const int first = static_cast<int>(blockIdx.x / ranks) * kRunPages;""")
# (pages a CTA, threads a CTA, uint4 a lane a trip, least CTAs an SM or
# None, the delta's stores) of commit_pages; the first is the source as
# it stands (pages.cuh's run), then runs of 4, 2 and 1 pages on as many
# warps, 16 pages on 8 warps (2 a warp) and on 16, two unrolls, a
# register cap for 3 CTAs an SM and evict-first stores
COMMIT_VARIANTS = [(8, 256, 8, None, "st"), (4, 128, 8, None, "st"),
                   (2, 64, 8, None, "st"), (1, 32, 8, None, "st"),
                   (16, 256, 8, None, "st"), (16, 512, 8, None, "st"),
                   (8, 256, 4, None, "st"), (8, 256, 2, None, "st"),
                   (8, 256, 8, 3, "st"), (8, 256, 8, None, "cs")]
# (mode, DIGEST) of each commit_pages entry point
COMMIT_INSTANCES = {"fused_commit": (0, 0), "fused_commit_stream": (0, 1),
                    "fused_verify_commit": (1, 0),
                    "fused_verify_commit_stream": (1, 1),
                    "fused_commit_old_terms": (2, 0),
                    "fused_commit_old_terms_stream": (2, 1),
                    "fused_accum_commit": (3, 0),
                    "fused_accum_commit_stream": (3, 1)}
# (VERIFY, DIGEST, stored = 0) of the syndrome entry points timed
SYNDROME_INSTANCES = {"fused_commit_s": (0, 0, False),
                      "fused_verify_commit_s": (1, 0, False),
                      "fused_commit_old_terms_s": (1, 0, True),
                      "fused_commit_s_stream": (0, 1, False),
                      "fused_verify_commit_s_stream": (1, 1, False)}


def sub(text, old, new):
    if old not in text:
        raise RuntimeError(f"the source no longer has {old!r}")
    return text.replace(old, new)


def resub(pattern, new, text):
    out, n = re.subn(pattern, new, text)
    if n != 1:
        raise RuntimeError(f"the source no longer has one {pattern!r}")
    return out


def xor_source(text, unroll, threads, hints, grid):
    text = resub(r"constexpr int kUnroll = \d+;",
                 f"constexpr int kUnroll = {unroll};", text)
    text = sub(text, "using pages::kThreads;",
               f"constexpr int kThreads = {threads};")
    text = sub(text, "{ return __ldg(p); }", "{ %s }" % HINTS[hints][0])
    text = sub(text, "{ *p = v; }", "{ %s }" % HINTS[hints][1])
    if grid == "resident":
        line = "    if (blocks == 0) blocks = 1;"
        text = sub(text, line, line + (
            "\n    static const int resident = resident_blocks("
            "reinterpret_cast<const void*>(xor_vec));"
            "\n    if (blocks > resident) blocks = resident;"))
    return text


def weight_source(text, unroll, trips, waves, min_blocks):
    text = resub(r"constexpr int kWordUnroll = \d+;",
                 f"constexpr int kWordUnroll = {unroll};", text)
    text = resub(r"constexpr int64_t kShare4 = \d+ \* kWordSpan4;",
                 f"constexpr int64_t kShare4 = {trips} * kWordSpan4;", text)
    if waves:
        line = "  const int64_t blocks = (lead * m4 + kShare4 - 1) / kShare4;"
        text = sub(text, line, line.replace("const int64_t", "int64_t") + (
            "\n  static const int resident = pages::resident_blocks("
            "reinterpret_cast<const void*>(weight_words<R, RAW0>));"
            f"\n  if (blocks > {waves} * resident) blocks = {waves} * "
            "resident;"))
    if min_blocks:
        text = sub(text, "__launch_bounds__(kThreads)\nweight_words(",
                   f"__launch_bounds__(kThreads, {min_blocks})\n"
                   "weight_words(")
    return text


def run_header(text, pages, threads, unroll, order):
    """pages.cuh with the page runs' sizes and CTA order set."""
    if order == "spread":
        text = sub(text, *SPREAD)
    text = resub(r"constexpr int kRunPages = \d+;",
                 f"constexpr int kRunPages = {pages};", text)
    text = resub(r"constexpr int kRunThreads = \d+;",
                 f"constexpr int kRunThreads = {threads};", text)
    return resub(r"constexpr int kLaneUnroll = \d+;",
                 f"constexpr int kLaneUnroll = {unroll};", text)


def run_variants(source, probes, quick):
    """({name: (source text, include dir)}, {name: {header: text}}) of the
    page-run variants of csrc/<source>.cu (and of their probes); only the
    first, the source as it stands, when `quick`."""
    text = open(os.path.join(CSRC, f"{source}.cu")).read()
    pages = open(os.path.join(CSRC, "pages.cuh")).read()
    probe = sub(open(os.path.join(CSRC, "gf.cuh")).read(), *PROBE)
    sources, headers = {}, {}
    for v in RUN_VARIANTS[:1] if quick else RUN_VARIANTS:
        name = "k%d_t%d_u%d_%s" % v
        for kind in ("", "probe_") if probes else ("",):
            sources[kind + name] = (text, CSRC)
            headers[kind + name] = {"pages.cuh": run_header(pages, *v),
                                    **({"gf.cuh": probe} if kind else {})}
    return sources, headers


def commit_source(text, min_blocks, store):
    if min_blocks:
        text = sub(text, "__launch_bounds__(kRunThreads)\ncommit_pages(",
                   f"__launch_bounds__(kRunThreads, {min_blocks})\n"
                   "commit_pages(")
    if store == "cs":
        text = sub(text, "pd[v] = d;", "__stcs(pd + v, d);")
    return text


def commit_runs(tmp, pages, stream, dev, ctl, quick):
    text = open(os.path.join(CSRC, "commit_fused.cu")).read()
    header = open(os.path.join(CSRC, "pages.cuh")).read()
    sources, headers = {}, {}
    for k, threads, unroll, min_blocks, store in (
            COMMIT_VARIANTS[:1] if quick else COMMIT_VARIANTS):
        name = "k%d_t%d_u%d_min%s_%s" % (k, threads, unroll, min_blocks,
                                          store)
        sources[name] = (commit_source(text, min_blocks, store), CSRC)
        headers[name] = {"pages.cuh": run_header(header, k, threads, unroll,
                                                 "rank")}
    fns = build(tmp, sources, "commit_pages_launch",
                [ctypes.c_void_p] * 8 + [
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p], headers)
    legacy = build(os.path.join(tmp, "controls"),
                   controls(ctl, "commit_fused"), "commit_pages_launch",
                   [ctypes.c_void_p] * 8 + [
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p])
    fns.update(legacy)
    from repro_torch.kernels import commit_fused as cf
    from repro_torch.kernels.fletcher import fletcher_pages_plain
    for shape in run_shapes():
        *lead, n, bw = shape
        n_pages = cs.G * n
        call = n_pages * bw * 4
        sets = []
        for _ in range(cs.ring_size(3 * call, 4 * call)):
            old, new = pages(shape), pages(shape)
            stored = fletcher_pages_plain(old)
            stored[..., ::997, 1] ^= 1
            sets.append(dict(
                old=old, new=new, acc=pages(shape), stored=stored,
                delta=torch.empty_like(new),
                terms=torch.empty(*lead, n, 2, dtype=torch.int32, device=dev),
                bad=torch.empty(*lead, n, dtype=torch.bool, device=dev),
                olds=torch.empty(*lead, n, 2, dtype=torch.int32, device=dev),
                zeros=torch.zeros(*lead, n, 2, dtype=torch.int32, device=dev),
                digest=torch.zeros(*lead, 2, dtype=torch.int32, device=dev)))

        def launch(name, st, mode, digest):
            fn, old_api = fns[name], name in legacy
            head = (st["old"].data_ptr(), st["new"].data_ptr(),
                    st["zeros" if old_api and mode == cf.OLD_TERMS
                       else "stored"].data_ptr(),
                    st["acc"].data_ptr(), st["delta"].data_ptr(),
                    st["terms"].data_ptr())
            if old_api:                       # verify, accum, digest flags
                return fn(*head, st["olds"].data_ptr(),
                          st["digest"].data_ptr(), n_pages, bw, n,
                          int(mode in (cf.VERIFY, cf.OLD_TERMS)),
                          int(mode == cf.ACCUM), digest, stream)
            return fn(*head,
                      st["bad" if mode == cf.VERIFY else "olds"].data_ptr(),
                      st["digest"].data_ptr(), n_pages, bw, n, mode, digest,
                      stream)
        st = sets[0]
        for entry, (mode, digest) in COMMIT_INSTANCES.items():
            want = cf.commit_pages_plain(
                st["old"], st["new"],
                st["stored"] if mode == cf.VERIFY else None,
                old_terms=mode == cf.OLD_TERMS, digest=bool(digest),
                acc=st["acc"] if mode == cf.ACCUM else None)
            side = (None if mode == cf.COMMIT else
                    "bad" if mode == cf.VERIFY else "olds")
            for name in fns:
                st["digest"].zero_()
                cs.check(launch(name, st, mode, digest) == 0,
                         f"{name}: launch failed")
                torch.cuda.synchronize()
                # a control's verify side is old terms ^ stored, not bad
                checked = (side if name not in legacy or side == "olds"
                           else None)
                cs.check(torch.equal(st["delta"], want[0])
                         and torch.equal(st["terms"], want[1])
                         and (checked is None
                              or torch.equal(st[checked], want[2]))
                         and (not digest or torch.equal(st["digest"],
                                                        want[3])),
                         f"{name} {entry} != plain")
            del want
            ms = timed({name: [functools.partial(launch, name, x, mode,
                                                 digest) for x in sets]
                        for name in fns})
            print(json.dumps({
                "kernel": "commit_pages", "entry": entry,
                "shape": list(shape), "ring": len(sets),
                "bound_ms": kcost.io_bytes(entry, n_pages * bw, n_pages,
                                           cs.G, 1)
                / cs.HBM_BYTES_PER_S * 1e3,
                "variants": [{"variant": k, "ms": v}
                             for k, v in ms.items()]}), flush=True)
        del sets, st
        torch.cuda.empty_cache()


def controls(args, source):
    out = {}
    for control in args:
        name, root = control.split("=", 1)
        cdir = os.path.join(root, "src", "repro_torch", "kernels", "csrc")
        out[name] = (open(os.path.join(cdir, f"{source}.cu")).read(), cdir)
    return out


def timed(calls):
    """{name: [device ms first to last, then last to first]}."""
    ms = {name: [] for name in calls}
    for name in list(calls) + list(reversed(list(calls))):
        ms[name].append(cs.device_ms(calls[name]))
    return ms


def run_shapes():
    """The main path's (G, 1, 2600, 1024) and the 16-page patch's."""
    return ((cs.G, 1, cs.PAGES, cs.BW), (cs.G, 1, 16, cs.BW))


def syndrome_runs(tmp, pages, stream, dev, ctl, quick):
    sources, headers = run_variants("gf_parity", True, quick)
    sources.update(controls(ctl, "gf_parity"))
    fns = build(tmp, sources, "syndrome_pages_launch",
                [ctypes.c_void_p] * 8 + [
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p], headers)
    from repro_torch.kernels import gf_parity as gfk
    from repro_torch.kernels.fletcher import fletcher_pages_plain
    r = cs.R
    coeffs = cs.coeff_table((cs.G, 1), r, dev)
    for shape in run_shapes():
        *lead, n, bw = shape
        n_pages = cs.G * n
        call = n_pages * bw * 4
        sets = []
        for _ in range(cs.ring_size(2 * call, call * (2 + r))):
            old, new = pages(shape), pages(shape)
            stored = fletcher_pages_plain(old)
            stored[..., ::997, 1] ^= 1
            sets.append(dict(
                old=old, new=new, stored=stored,
                sdelta=torch.empty(*lead, r, n, bw, dtype=torch.int32,
                                   device=dev),
                terms=torch.empty(*lead, n, 2, dtype=torch.int32, device=dev),
                mism=torch.empty(*lead, n, 2, dtype=torch.int32, device=dev),
                zeros=torch.zeros(*lead, n, 2, dtype=torch.int32, device=dev),
                digest=torch.zeros(*lead, 2, dtype=torch.int32, device=dev)))

        def launch(fn, st, verify, digest, zero):
            return fn(st["old"].data_ptr(), st["new"].data_ptr(),
                      coeffs.data_ptr(),
                      st["zeros" if zero else "stored"].data_ptr(),
                      st["sdelta"].data_ptr(), st["terms"].data_ptr(),
                      st["mism"].data_ptr(), st["digest"].data_ptr(),
                      n_pages, bw, n, r, verify, digest, stream)
        st = sets[0]
        for entry, (verify, digest, zero) in SYNDROME_INSTANCES.items():
            sdelta, terms, mism, dig = gfk.syndrome_pages_plain(
                st["old"], st["new"], coeffs,
                st["zeros" if zero else "stored"] if verify else None,
                bool(digest))
            for name, fn in fns.items():
                st["digest"].zero_()
                cs.check(launch(fn, st, verify, digest, zero) == 0,
                         f"{name}: launch failed")
                torch.cuda.synchronize()
                cs.check(name.startswith("probe") or (
                    torch.equal(st["sdelta"], sdelta)
                    and torch.equal(st["terms"], terms)
                    and (not verify or torch.equal(st["mism"], mism))
                    and (not digest or torch.equal(st["digest"], dig))),
                    f"{name} {entry} != plain")
            del sdelta, terms, mism, dig
            ms = timed({name: [functools.partial(launch, fn, x, verify,
                                                 digest, zero)
                               for x in sets] for name, fn in fns.items()})
            print(json.dumps({
                "kernel": "syndrome_pages", "entry": entry, "r": r,
                "shape": list(shape), "ring": len(sets),
                "bound_ms": kcost.io_bytes(entry, n_pages * bw, n_pages,
                                           cs.G, r)
                / cs.HBM_BYTES_PER_S * 1e3,
                "variants": [{"variant": k, "ms": v}
                             for k, v in ms.items()]}), flush=True)
        del sets, st
        torch.cuda.empty_cache()


def fletcher_runs(tmp, pages, stream, dev, ctl, quick):
    sources, headers = run_variants("fletcher", False, quick)
    sources.update(controls(ctl, "fletcher"))
    fns = build(tmp, sources, "fletcher_pages_launch",
                [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p], headers)
    from repro_torch.kernels.fletcher import fletcher_stream_plain
    for shape in run_shapes():
        *lead, n, bw = shape
        n_pages = cs.G * n
        call = n_pages * bw * 4
        sets = [(pages(shape),
                 torch.empty(*lead, n, 2, dtype=torch.int32, device=dev),
                 torch.zeros(*lead, 2, dtype=torch.int32, device=dev))
                for _ in range(cs.ring_size(call, call))]
        x, terms, dig = sets[0]
        want_terms, want_dig = fletcher_stream_plain(x)
        for name, fn in fns.items():
            for digest in (1, 0):
                dig.zero_()
                cs.check(fn(x.data_ptr(), terms.data_ptr(), dig.data_ptr(),
                            n_pages, bw, n, digest, stream) == 0,
                         f"{name}: launch failed")
                torch.cuda.synchronize()
                cs.check(torch.equal(terms, want_terms) and (
                    not digest or torch.equal(dig, want_dig)),
                    f"{name} digest={digest} != plain")
        for entry, digest in (("fletcher_stream", 1), ("fletcher_blocks", 0)):
            ms = timed({name: [functools.partial(
                fn, a.data_ptr(), t.data_ptr(), d.data_ptr(), n_pages, bw, n,
                digest, stream) for a, t, d in sets]
                for name, fn in fns.items()})
            print(json.dumps({
                "kernel": "fletcher_pages", "entry": entry,
                "shape": list(shape), "ring": len(sets),
                "bound_ms": kcost.io_bytes(entry, n_pages * bw, n_pages,
                                           cs.G, 1)
                / cs.HBM_BYTES_PER_S * 1e3,
                "variants": [{"variant": k, "ms": v}
                             for k, v in ms.items()]}), flush=True)
        del sets, x, terms, dig
        torch.cuda.empty_cache()


def build(tmp, sources, symbol, argtypes, headers=None):
    """Compile each {name: (source text, include dir)}, each in a directory
    of its own that also holds `headers[name]` ({file name: text}, found
    before the include dir's); returns {name: fn}."""
    jobs = []
    for name, (text, include) in sources.items():
        os.makedirs(os.path.join(tmp, name))
        for header, body in (headers or {}).get(name, {}).items():
            with open(os.path.join(tmp, name, header), "w") as f:
                f.write(body)
        src = os.path.join(tmp, name, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(tmp, name, f"{name}.so")
        cmd = [shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc",
               "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", include,
               "-o", so, src]
        jobs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fns = {}
    for name, so, proc in jobs:
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(so), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        fns[name] = fn
    return fns


def xor_runs(tmp, pages, stream):
    text = open(os.path.join(CSRC, "xor_parity.cu")).read()
    fns = build(tmp, {"xor_u%d_t%d_%s_%s" % v: (xor_source(text, *v), CSRC)
                      for v in XOR_VARIANTS},
                "xor_words_launch", [ctypes.c_void_p] * 3 + [
                    ctypes.c_longlong, ctypes.c_void_p])
    for shape in ((cs.G, 1, cs.PAGES, cs.BW),
                  (cs.G, 1, cs.FLUSH_SLOTS, cs.BW)):
        words = 1
        for d in shape:
            words *= d
        sets = [(pages(shape), pages(shape), pages(shape))
                for _ in range(cs.ring_size(2 * words * 4, 3 * words * 4))]
        for name, fn in fns.items():
            x, y, o = sets[0]
            cs.check(fn(x.data_ptr(), y.data_ptr(), o.data_ptr(), words,
                        stream) == 0, f"{name}: launch failed")
            torch.cuda.synchronize()
            cs.check(torch.equal(o, x ^ y), f"{name} != plain")
        lib = [functools.partial(torch.bitwise_xor, x, y)
               for x, y, _ in sets]
        rows = []
        for name, fn in fns.items():
            calls = [functools.partial(fn, x.data_ptr(), y.data_ptr(),
                                       o.data_ptr(), words, stream)
                     for x, y, o in sets]
            ms = [cs.device_ms(calls), cs.device_ms(lib), cs.device_ms(lib),
                  cs.device_ms(calls)]
            rows.append({"variant": name, "ms": [ms[0], ms[3]],
                         "library_ms": [ms[1], ms[2]]})
        print(json.dumps({
            "kernel": "xor_words", "shape": list(shape), "ring": len(sets),
            "bound_ms": 3 * words * 4 / cs.HBM_BYTES_PER_S * 1e3,
            "variants": rows}), flush=True)
        del sets
        torch.cuda.empty_cache()


def weight_runs(tmp, pages, stream, dev, controls):
    text = open(os.path.join(CSRC, "gf_parity.cu")).read()
    probe = sub(open(os.path.join(CSRC, "gf.cuh")).read(), *PROBE)
    sources, headers = {}, {}
    for v in WEIGHT_VARIANTS:
        name = "u%d_trips%d_waves%s_min%s" % v
        sources[name] = sources["probe_" + name] = (weight_source(text, *v),
                                                    CSRC)
        headers["probe_" + name] = {"gf.cuh": probe}
    for control in controls:
        name, root = control.split("=", 1)
        cdir = os.path.join(root, "src", "repro_torch", "kernels", "csrc")
        sources[name] = (open(os.path.join(cdir, "gf_parity.cu")).read(),
                         cdir)
    fns = build(tmp, sources, "weight_words_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p], headers)
    from repro_torch.kernels import gf_parity as gfk
    coeffs = cs.coeff_table((cs.G, 1), cs.R, dev)
    for m in (cs.PAGES * cs.BW, cs.FLUSH_SLOTS * cs.BW):
        words = cs.G * m
        nbytes = words * 4 * (1 + cs.R) + cs.G * cs.R * 4
        xs = [pages((cs.G, 1, m))
              for _ in range(cs.ring_size(words * 4, nbytes))]
        outs = [torch.empty(cs.G, 1, cs.R, m, dtype=torch.int32, device=dev)
                for _ in xs]
        want = gfk.sdelta_stack_plain(xs[0], coeffs)
        calls = {}
        for name, fn in fns.items():
            outs[0].zero_()
            cs.check(fn(xs[0].data_ptr(), coeffs.data_ptr(), 0,
                        outs[0].data_ptr(), cs.G, m, cs.R, 1, stream) == 0,
                     f"{name}: launch failed")
            torch.cuda.synchronize()
            cs.check(name.startswith("probe") or torch.equal(outs[0], want),
                     f"{name} != plain")
            calls[name] = [functools.partial(
                fn, x.data_ptr(), coeffs.data_ptr(), 0, o.data_ptr(), cs.G,
                m, cs.R, 1, stream) for x, o in zip(xs, outs)]
        del want
        calls["torch_expand_copy"] = [
            functools.partial(lambda x: x.unsqueeze(-2).expand(
                cs.G, 1, cs.R, m).contiguous(), x) for x in xs]
        ms = {name: [] for name in calls}
        for name in list(calls) + list(reversed(list(calls))):
            ms[name].append(cs.device_ms(calls[name]))
        print(json.dumps({
            "kernel": "weight_words", "entry": "sdelta_stack", "r": cs.R,
            "shape": [cs.G, 1, m], "ring": len(xs),
            "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
            "variants": [{"variant": n, "ms": v} for n, v in ms.items()]}),
            flush=True)
        del xs, outs, calls
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--control", action="append", default=[],
                    help="NAME=DIR: a checkout whose kernels are timed as "
                    "they are")
    ap.add_argument("--only", default="commit,syndrome,fletcher,weight,xor",
                    help="comma-separated kernels to time")
    ap.add_argument("--quick", action="store_true",
                    help="commit, syndrome, fletcher: the sources as they "
                    "stand and the controls only")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def pages(shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=dev, generator=gen)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        if "commit" in only:
            commit_runs(os.path.join(tmp, "c"), pages, stream, dev,
                        args.control, args.quick)
        if "syndrome" in only:
            syndrome_runs(os.path.join(tmp, "s"), pages, stream, dev,
                          args.control, args.quick)
        if "fletcher" in only:
            fletcher_runs(os.path.join(tmp, "f"), pages, stream, dev,
                          args.control, args.quick)
        if "weight" in only:
            weight_runs(os.path.join(tmp, "w"), pages, stream, dev,
                        args.control)
        if "xor" in only:
            xor_runs(os.path.join(tmp, "x"), pages, stream)


if __name__ == "__main__":
    main()
