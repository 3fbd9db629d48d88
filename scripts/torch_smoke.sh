#!/usr/bin/env bash
# The port's smoke: its CPU tests against the reference and the four
# examples on the card.
#
#   scripts/torch_smoke.sh               # examples on the GPU
#   scripts/torch_smoke.sh --device cpu  # examples on the CPU
#
# The examples exercise the port's `Pool` facade, Server and Trainer end
# to end (torch_quickstart runs in full; the other three run their
# --smoke pass), so any drift in the public surface fails here.  One short
# chaos scenario runs traced, and its trace is re-validated offline.
# There is no bench or gate step: the port's benchmark is its own.
set -euo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
DEVICE="cuda"
if [[ "${1:-}" == "--device" ]]; then
    DEVICE="$2"
fi

echo "== port tests: pytest tests/test_torch_*.py =="
python -m pytest -x -q tests/test_torch_*.py

echo "== examples on $DEVICE: quickstart + --smoke passes =="
python examples/torch_quickstart.py --device "$DEVICE"
python examples/torch_serve_protected.py --smoke --device "$DEVICE"
python examples/torch_train_fault_tolerant.py --smoke --device "$DEVICE"
# one r=3 cell: triple-loss survival through the Reed-Solomon stack
python examples/torch_train_fault_tolerant.py --smoke --redundancy 3 \
    --device "$DEVICE"
python examples/torch_elastic_rescale.py --smoke --device "$DEVICE"
# one short chaos scenario: mid-window scribble+loss under traffic,
# recovered online, end state bit-identical to the fault-free run —
# traced, and the trace re-validated offline (every fault span linked)
TRACE_DIR="$(mktemp -d)"
python -m repro_torch.chaos --smoke --trace-dir "$TRACE_DIR" \
    --device "$DEVICE"
python scripts/torch_trace_check.py --dir "$TRACE_DIR"
rm -rf "$TRACE_DIR"

echo "torch smoke OK"
