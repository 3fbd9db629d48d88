"""The per-layer metrics read from the program's own layer spans
(`repro_torch.obs.trace.layer_totals`, filled only while a profiler
records): a traced CPU run of each cell at the small size reports every
one of them that the cell lists, beside the per-layer metrics it reported
before; an untraced run reports none; and the trace's reduction puts no
`pgl.` range among the device's ops or the idle gaps' spans."""
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import run as bench   # noqa: E402

bench.environment()
from portbench import harness, layers, tiny   # noqa: E402
from repro_torch.obs import trace   # noqa: E402

SEED = 2 ** 31 + 4321
SPEC = harness.load_spec()
CELLS = [c["name"] for c in SPEC["workloads"]]
SPAN_METRICS = {"commit_key_ms", "commit_program_hit", "zone_copy_ms",
                "ring_wait_ms", "step_decode_ms", "step_footprint_ms"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def per_layer(cell: str) -> dict:
    """The cell's per-layer metrics: those read from the program's spans,
    and the others but the device trace's (no device number on the
    CPU)."""
    ms = harness.cell_metrics(SPEC, cell, "per_layer")
    spans = {m["name"] for m in ms if m["name"].split(".")[0] in
             SPAN_METRICS}
    host = {m["name"] for m in ms if m["source"] != "device_trace"} - spans
    return {"spans": spans, "host": host}


def cell_run(cell, trace_on, seconds, traced_s, keep=None):
    spec_cell = harness.find(SPEC["workloads"], cell, "workload")
    traced, bench.TRACED_S = bench.TRACED_S, traced_s
    device_trace = harness.DeviceTrace

    class Kept(device_trace):
        def finish(self):
            super().finish()
            if keep is not None:
                keep.append(dict(self.out))
    harness.DeviceTrace = Kept
    try:
        res, _ = bench.run(
            cell, SEED, seconds, trace_on, device=torch.device("cpu"),
            config_overrides=tiny.CONFIGS[spec_cell["config"]],
            mix_overrides=tiny.MIXES.get(spec_cell["traffic"], {}))
    finally:
        bench.TRACED_S = traced
        harness.DeviceTrace = device_trace
    return res


def test_every_cell_lists_its_span_metrics():
    want = {"pool_bulk": 3, "pool_patch": 4, "pool_faults": 3,
            "xlstm_serve": 5}
    assert {c: len(per_layer(c)["spans"]) for c in CELLS} == want


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_span_metrics(cell):
    kept = []
    res = cell_run(cell, True, seconds=2.0, traced_s=0.05, keep=kept)
    assert res["correct"], res["checks"]
    names = set(res["metrics"])
    want = per_layer(cell)
    assert want["spans"] <= names, want["spans"] - names
    assert want["host"] <= names, want["host"] - names
    for name in want["spans"]:
        v = res["metrics"][name]["value"]
        assert v >= 0 and (v <= 100 or not name.startswith("commit_program"))
    spans = trace.layer_totals()
    denominator = "serve.step" if cell == "xlstm_serve" else "pool.commit"
    assert spans[denominator]["n"] >= 1
    # the reduction the card's breakdown comes from names no layer span
    (out,) = kept
    named = [n for n, _ in out["device_ops"] + out["idle_gaps"]]
    assert not any(n.startswith(trace.LAYER_PREFIX) for n in named), named


@pytest.mark.parametrize("cell", ["pool_patch", "xlstm_serve"])
def test_untraced_run_reports_none_and_records_nothing(cell):
    before = trace.layer_totals()
    res = cell_run(cell, False, seconds=0.3, traced_s=0.05)
    assert res["correct"]
    assert not {n for n in res["metrics"] if n.split(".")[0] in
                SPAN_METRICS}
    assert trace.layer_totals() == before


def test_readers_read_nothing_without_the_program_spans(monkeypatch):
    """A program without layer spans (or with an empty table) gives the
    readers nothing: each returns None and none raises."""
    monkeypatch.delattr(trace, "layer_totals")
    assert layers.totals() == {}
    for m in SPEC["per_layer"]:
        if m["name"].split(".")[0] in SPAN_METRICS:
            reader = harness.load_module(harness.metric_path(m["name"]),
                                         "span_reader")
            assert reader.read({}) is None, m["name"]


def test_device_trace_reduction_leaves_layer_ranges_out():
    """A `pgl.` range on the host is neither a device op nor a span that
    takes an idle gap.  The events carry no `activity_type`, as the card's
    profiler gives them: there any range on the device's timeline not named
    `pb.` counts as device work, so the program's ranges are operator
    ranges, which no profiler mirrors there (held by
    tests/test_torch_obs_layers.py::test_ranges_appear_nested_in_the_profile)."""
    class E:
        def __init__(self, name, dev, start, dur):
            self._v = (name, dev, start, dur)

        def name(self):
            return self._v[0]

        def device_type(self):
            return self._v[1]

        def start_ns(self):
            return self._v[2]

        def duration_ns(self):
            return self._v[3]
    cpu, cuda = "DeviceType.CPU", "DeviceType.CUDA"
    ev = [E("pb.window", cpu, 0, 100),
          E("pb.commit", cpu, 10, 60),
          E("pgl.pool.commit", cpu, 12, 55),
          E("pgl.txn.commit_program", cpu, 14, 20),
          E("void commit_pages<0, false>(int)", cuda, 40, 10)]
    out = harness.reduce_trace(ev)
    assert out["busy_s"] == 10e-9
    assert [n for n, _ in out["device_ops"]] == ["commit_pages<0, false>"]
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"commit": 40e-9, "outside any benchmark span": 50e-9})
