"""What an `xor_delta` call costs the host, piece by piece.

    python3 scripts/torch_xor_cost.py [--src DIR] [--tag NAME]

Needs one CUDA card.  `--src` names the `src` directory whose `repro_torch`
is measured (default: this checkout's), so an older tree unpacked beside
it can be measured in the same run.  Prints one JSON line: the host µs a
call (chip_smoke's `host_us`: 1000 enqueues and one synchronize, at one
page of 1024 words, where the kernel takes less than its enqueue) of
`ops.xor_delta` and of `torch.bitwise_xor`, and of the pieces of the
wrapper's path — the operand checks, a `torch.cuda.Stream` object's
handle, the raw stream handle (where the tree has
`_build.stream_handle`), the output's allocation and the bare ctypes
launch.  The kernel's own device time against the library's is
scripts/torch_kernel_variants.py's.
"""
import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_xor_cost: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs             # puts this tree's src on the path
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import xor_parity as xp

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def pages(shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    a, b = pages((1, cs.BW)), pages((1, cs.BW))
    out = torch.empty_like(a)
    fn = xp._lib()
    launch = (a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
              torch.cuda.current_stream(dev).cuda_stream)
    host = {
        "ops.xor_delta": cs.host_us(lambda: ops.xor_delta(a, b)),
        "torch.bitwise_xor": cs.host_us(lambda: torch.bitwise_xor(a, b)),
        "check_operands": cs.host_us(
            lambda: xp.check_operands(a, b, "xor_delta")),
        "current_stream().cuda_stream": cs.host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "empty_like": cs.host_us(lambda: torch.empty_like(a)),
        "ctypes launch": cs.host_us(lambda: fn(*launch)),
    }
    if hasattr(_build, "stream_handle"):
        host["_build.stream_handle"] = cs.host_us(
            lambda: _build.stream_handle(dev))
    print(json.dumps({"tree": args.tag, "host_us": host}), flush=True)


if __name__ == "__main__":
    main()
