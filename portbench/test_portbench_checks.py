"""A whole run of every cell on the CPU at a small size, with the chip's
look skipped: sound, it comes out correct; with the timed path broken
underneath (a step that keeps its state, an answer altered where it is
produced, half of a batch left out, a recovery that rebuilds nothing) or
the control in the program's place, `correct` comes out false."""
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import run as bench   # noqa: E402

bench.environment()
from portbench import harness, tiny   # noqa: E402

SEED = 2 ** 31 + 12345          # past 32 signed bits, as a run's seed may be


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cell_run(workload, fault=None, seconds=0.3, trace=False,
             traced_s=0.1):
    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], workload, "workload")
    traced, bench.TRACED_S = bench.TRACED_S, traced_s
    try:
        res, _ = bench.run(workload, SEED, seconds, trace,
                           device=torch.device("cpu"),
                           config_overrides=tiny.CONFIGS[cell["config"]],
                           mix_overrides=tiny.MIXES.get(cell["traffic"], {}),
                           fault=fault)
    finally:
        bench.TRACED_S = traced
    return res


@pytest.mark.parametrize("workload,fault", [
    ("pool_bulk", None), ("pool_patch", None), ("pool_faults", None),
    ("xlstm_serve", None)])
def test_sound_run_is_correct(workload, fault):
    res = cell_run(workload, fault)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    e2e = {m["name"] for m in harness.cell_metrics(
        harness.load_spec(), workload, "end_to_end")}
    assert set(res["metrics"]) == e2e
    assert list(res["checks"]) and all(
        v["value"] <= v["limit"] for v in res["checks"].values())


@pytest.mark.parametrize("workload,fault,caught", [
    ("pool_bulk", "unchanged", "state_words_off"),
    ("pool_bulk", "altered", "stack_words_off"),
    ("pool_bulk", "stale_stack", "stack_words_off"),
    ("pool_patch", "unchanged", "state_words_off"),
    ("pool_patch", "altered", "stack_words_off"),
    ("pool_patch", "stale_stack", "stack_words_off"),
    ("pool_faults", "no_repair", "recovered_words_off"),
    ("pool_faults", "unchanged", "state_words_off"),
    ("xlstm_serve", "unchanged", "served_gap_mean"),
    ("xlstm_serve", "altered", "served_gap_mean"),
    ("xlstm_serve", "half", "served_gap_mean")])
def test_broken_path_is_not_correct(workload, fault, caught):
    res = cell_run(workload, fault)
    assert not res["correct"]
    assert res["checks"][caught]["value"] > res["checks"][caught]["limit"]


def test_serve_control_reads_beside():
    """The control, the tokens the float8 reference puts first judged in
    the served ones' place, fails the comparison; the program's own
    readings are kept beside it."""
    res = cell_run("xlstm_serve", "fp8")
    assert not res["correct"]
    gap = res["checks"]["served_gap_mean"]
    assert gap["value"] > gap["limit"]
    assert gap["value"] == res["readings"]["control_gap_mean"]
    assert {"served_gap", "served_gap_mean", "control_gap",
            "control_gap_mean", "positions"} <= set(
        res["readings"])


# the per-layer metrics taken from host clocks, read after the trace
HOST_METRICS = {"pool_patch": {"commit_dispatch_ms.pool",
                               "commit_roofline.pool", "commit_p95_ms.patch"},
                "xlstm_serve": {"commit_dispatch_ms.serve",
                                "step_p90_ms.serve", "decode_mfu"}}


@pytest.mark.parametrize("workload", sorted(HOST_METRICS))
def test_traced_run_reads_its_layers(workload):
    """A `--trace 1` run on the CPU: the profiler runs and is read, and
    the per-layer metrics that need no card are there, their host clocks
    read over the window after the trace; those of the device trace are
    left out (no device number from a CPU run)."""
    res = cell_run(workload, trace=True, seconds=2.0, traced_s=0.05)
    assert res["correct"]
    names = set(res["metrics"])
    assert HOST_METRICS[workload] <= names
    assert not any(n.startswith(("kernel_roofline", "device_idle"))
                   for n in names)
    assert "busy_s" not in res["device"]


@pytest.mark.parametrize("workload", sorted(HOST_METRICS))
def test_host_metrics_read_after_the_trace(workload):
    """A traced run's host clocks cover only the window after the
    profiler stopped: where it never stopped, they read nothing."""
    res = cell_run(workload, trace=True, seconds=0.6, traced_s=5.0)
    assert res["correct"] and res["attempted"] > 0
    assert not HOST_METRICS[workload] & set(res["metrics"])
