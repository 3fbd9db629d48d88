"""Time variants of the `xor_words` and `weight_words` kernels.

    python3 scripts/torch_kernel_variants.py [--control NAME=DIR ...]

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
                    help="NAME=DIR: a checkout whose weight_words is timed "
                    "as it is")
    args = ap.parse_args()
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
        weight_runs(tmp, pages, stream, dev, args.control)
        xor_runs(tmp, pages, stream)


if __name__ == "__main__":
    main()
