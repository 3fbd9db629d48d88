"""Count the machine instructions of the port's CUDA kernels by opcode.

    python3 scripts/torch_sass_counts.py [source ...]

Needs the CUDA toolkit (nvcc, cuobjdump, cu++filt), not a card.  Compiles
each `src/repro_torch/kernels/csrc/<source>.cu` (default: fletcher,
gf_parity and xor_parity) for sm_90a into a cubin in a temporary directory
with
`-Xptxas -v`, disassembles it with `cuobjdump -sass`, and prints one JSON
line per kernel instantiation: its demangled name, ptxas's registers,
static shared memory and spill bytes, its instruction count and the counts
of the opcodes that carry the integer work (LOP3, SHF, IMAD, IADD3), the
shared-memory loads (LDS) and the local-memory traffic (LDL, STL): one
line per instance, so each `syndrome_pages<R, VERIFY, DIGEST>` and
`fletcher_pages<DIGEST>` has its own.  The LDS counts of weight_words and
syndrome_pages show their table multiply's lookups coming from shared
memory, and LDL / STL = 0 that no register array spilled to local memory.
Exits 1 if any kernel spills or touches local memory.
"""
import collections
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
CUDA_BIN = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin")
KEEP = ("LOP3", "SHF", "IMAD", "IADD3", "LDS", "LDL", "STL")


def tool(name):
    return os.path.join(CUDA_BIN, name)


def ptxas_info(log):
    """{mangled kernel: {registers, smem_bytes, spill_stores, spill_loads}}
    from nvcc -Xptxas -v."""
    info, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            info[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            info[fn]["spill_stores"] = int(m.group(1))
            info[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            info[fn]["smem_bytes"] = int(m.group(1)) if m else 0
    return info


def sass_counts(source, tmp):
    cubin = os.path.join(tmp, f"{source}.cubin")
    log = subprocess.run(
        [tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-Xptxas", "-v", "-cubin", "-o", cubin,
         os.path.join(CSRC, f"{source}.cu")], check=True, timeout=600,
        capture_output=True, text=True)
    sass = subprocess.run([tool("cuobjdump"), "-sass", cubin], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if fn is not None and m:
            counts[fn][m.group(1)] += 1
    return counts, ptxas_info(log.stdout + log.stderr)


def demangle(names):
    out = subprocess.run([tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.splitlines()
    return dict(zip(names, out))


def main():
    sources = sys.argv[1:] or ["fletcher", "gf_parity", "xor_parity"]
    local = []
    with tempfile.TemporaryDirectory() as tmp:
        for source in sources:
            counts, info = sass_counts(source, tmp)
            names = demangle(list(counts))
            for fn, c in counts.items():
                row = {"source": f"{source}.cu", "kernel": names[fn],
                       **info.get(fn, {}), "instructions": sum(c.values()),
                       **{op: c.get(op, 0) for op in KEEP}}
                print(json.dumps(row), flush=True)
                if (row.get("spill_stores") or row.get("spill_loads")
                        or row["LDL"] or row["STL"]):
                    local.append(row["kernel"])
    if local:
        sys.exit(f"torch_sass_counts: local memory in {local}")


if __name__ == "__main__":
    main()
