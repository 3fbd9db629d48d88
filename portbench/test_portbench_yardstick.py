"""The frozen yardstick: the bounds of the port's kernel table at the main
path's shape (100, 1, 2600, 1024) int32, r = 3, and the same arithmetic
as the program's own copy when the benchmark was written."""
import contextlib
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

from portbench.reference import yardstick as Y   # noqa: E402

WORDS = 100 * 2600 * 1024
PAGES = 100 * 2600
PLANE = 100 * 26624          # gf_scale's one (100, 1, 26624) plane


def bounds_ms(name, words=WORDS, pages=PAGES, r=3):
    nbytes = Y.io_bytes(name, words, pages, 100, r)
    ops = Y.int_ops(name, words, r)
    return (nbytes / Y.HBM_BYTES_PER_S * 1e3,
            ops / Y.INT32_OPS_PER_S * 1e3)


# (entry point, bytes bound ms, ops bound ms) as the kernel table prints
# them, to its digits
TABLE = [("fletcher_blocks", 0.319, 0.0478),
         ("fused_commit", 0.954, 0.0637),
         ("fused_verify_commit", 0.955, 0.111),
         ("fused_accum_commit", 1.273, 0.127),
         ("fused_commit_s", 1.590, 0.287),
         ("fused_verify_commit_s", 1.591, 0.334),
         ("sdelta_stack", 1.272, 0.223),
         ("xor_delta", 0.954, 0.0159)]


@pytest.mark.parametrize("name,b_ms,o_ms", TABLE)
def test_table_bounds(name, b_ms, o_ms):
    got_b, got_o = bounds_ms(name)
    assert round(got_b, 3) == b_ms
    assert float(f"{got_o:.3g}") == o_ms


def test_gf_scale_bounds():
    got_b, got_o = bounds_ms("gf_scale", words=PLANE, pages=0)
    assert (round(got_b, 4), float(f"{got_o:.3g}")) == (0.0064, 0.00111)


@pytest.mark.parametrize("name", sorted(Y.BASE_OPS))
@pytest.mark.parametrize("r", [1, 3])
def test_same_as_the_program_copy(name, r):
    from repro_torch.kernels import cost
    for words, pages, ranks in ((WORDS, PAGES, 100), (4096, 4, 8)):
        assert Y.io_bytes(name, words, pages, ranks, r) == cost.io_bytes(
            name, words, pages, ranks, r)
        assert Y.int_ops(name, words, r) == cost.int_ops(name, words, r)


def test_launch_bound_recovers_the_operand():
    """The words, pages and ranks of a launch follow from its operand's
    shape: the bound equals the table's."""
    nbytes, ops, least, binds = Y.launch_bound_s(
        "fused_commit_s", (100, 1, 2600, 1024), 3)
    assert nbytes == Y.io_bytes("fused_commit_s", WORDS, PAGES, 100, 3)
    assert ops == Y.int_ops("fused_commit_s", WORDS, 3)
    assert binds == "bytes" and round(least * 1e3, 3) == 1.590
    nbytes, _, _, _ = Y.launch_bound_s("gf_scale", (100, 1, 26624), 1)
    assert nbytes == Y.io_bytes("gf_scale", PLANE, 0, 100, 1)


def test_launches_record_the_operand_shape():
    """The benchmark's record takes each launch's operand shape at the
    program's hook, and the yardstick's bytes from it are what the
    program reckoned when the benchmark was written."""
    import torch
    from portbench.harness import Launches
    from repro_torch.kernels import cost, ops

    class Counter:
        def __init__(self):
            self.seen = []

        def kernel(self, name, nbytes, int_ops):
            self.seen.append((name, nbytes, int_ops))
            return contextlib.nullcontext()

    rec, counter, hook = Launches(), Counter(), cost.launch
    x = torch.arange(8 * 3 * 64, dtype=torch.int32).view(8, 3, 64)
    rec.install()
    cost.push(counter)
    try:
        ops.fletcher_blocks(x)
        ops.xor_delta(x.view(8, -1), x.view(8, -1))
    finally:
        cost.pop(counter)
        rec.remove()
    assert cost.launch is hook and rec.records == [
        ("fletcher_blocks", (8, 3, 64), 1), ("xor_delta", (8, 192), 1)]
    for (name, shape, r), (_, nbytes, int_ops) in zip(rec.records,
                                                      counter.seen):
        assert Y.launch_bound_s(name, shape, r)[:2] == (nbytes, int_ops)


def test_commit_least_bytes_bulk():
    """The r = 3 bulk commit of the 1.065 GB zone: ~3.26 GB, ~0.97 ms."""
    row = 2600 * 1024
    state = 100 * 2654209
    b = Y.commit_least_bytes(ranks=100, row_words=row, block_words=1024,
                             r=3, state_words=state)
    assert b == 4 * (state + 100 * row + 3 * row) + 4 * (
        100 * row + 3 * row) + 8 * 100 * 2600 + 8 * 100
    assert 0.95e-3 < b / Y.HBM_BYTES_PER_S < 1.0e-3


def test_xlstm_flops():
    cfg = {"d_model": 2048, "n_heads": 4, "vocab": 50304, "n_layers": 48,
           "block_pattern": ["mlstm"] * 7 + ["slstm"],
           "mlstm_proj_factor": 2, "conv_kernel": 4}
    out = Y.xlstm_decode_flops(cfg)
    assert (out["mlstm_blocks"], out["slstm_blocks"]) == (42, 6)
    assert 4.0e9 < out["flops_per_token"] < 4.8e9
