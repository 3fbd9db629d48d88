"""Count the machine instructions of the port's CUDA kernels by opcode.

    python3 scripts/torch_sass_counts.py [source ...]

Needs the CUDA toolkit (nvcc, cuobjdump, cu++filt), not a card.  Compiles
each `src/repro_torch/kernels/csrc/<source>.cu` (default: gf_parity) for
sm_90a into a cubin in a temporary directory, disassembles it with
`cuobjdump -sass`, and prints one JSON line per kernel instantiation: its
demangled name, its instruction count and the counts of the opcodes that
carry the integer work (LOP3, SHF, IMAD, IADD3).  The syndrome sweeps'
counts show how many instructions the GF(2^32) multiply costs a word a
step once compiled, which chip_smoke.py's operation bound relies on.
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
KEEP = ("LOP3", "SHF", "IMAD", "IADD3")


def tool(name):
    return os.path.join(CUDA_BIN, name)


def sass_counts(source, tmp):
    cubin = os.path.join(tmp, f"{source}.cubin")
    subprocess.run([tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-cubin", "-o", cubin,
                    os.path.join(CSRC, f"{source}.cu")], check=True,
                   timeout=600)
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
    return counts


def demangle(names):
    out = subprocess.run([tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.splitlines()
    return dict(zip(names, out))


def main():
    sources = sys.argv[1:] or ["gf_parity"]
    with tempfile.TemporaryDirectory() as tmp:
        for source in sources:
            counts = sass_counts(source, tmp)
            names = demangle(list(counts))
            for fn, c in counts.items():
                print(json.dumps({
                    "source": f"{source}.cu", "kernel": names[fn],
                    "instructions": sum(c.values()),
                    **{op: c.get(op, 0) for op in KEEP}}), flush=True)


if __name__ == "__main__":
    main()
