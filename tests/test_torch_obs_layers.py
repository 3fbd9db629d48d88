"""The layer spans of repro_torch.obs.trace: with no profiler recording
they record nothing and open no profiler range; under a profiler each is a
`pgl.<name>` range beside the operators, and a row of the span table
(count, total and self time, the enclosing span) that holds the latest
profiling session.  Then the spans the program opens in a commit and a
served step, and `Tracer.span` as a layer span with its parent."""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import P, Pool, ProtectConfig, ZoneMesh
from repro_torch.chaos import scenarios
from repro_torch.configs.base import ModelConfig
from repro_torch.obs import trace
from repro_torch.obs.trace import Tracer, validate_events
from repro_torch.runtime.server import Server

BW = 64


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


def off_span():
    """A span with no profiler recording (the program between sessions)."""
    with trace.layer("between"):
        pass


def ranges(prof) -> list:
    """(name, start ns, end ns) of every `pgl.` range the profiler saw."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(trace.LAYER_PREFIX):
            s = e.start_ns()
            out.append((e.name()[len(trace.LAYER_PREFIX):], s,
                        s + e.duration_ns()))
    return out


def small_pool(**cfg):
    gen = torch.Generator().manual_seed(0)
    state = {"w": torch.randn(8, 256, generator=gen),
             "b": torch.randn(16, generator=gen)}
    return Pool.open(state, {"w": P("data", None), "b": P()},
                     mesh=ZoneMesh((4, 2), ("data", "model")),
                     config=ProtectConfig(mode="mlpc", block_words=BW, **cfg),
                     device="cpu")


def bumped(pool, c):
    return {k: v + c for k, v in pool.state.items()}


# -- the table ------------------------------------------------------------------


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with no profiler")
    monkeypatch.setattr(trace, "_range", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not trace.profiling()
    before = trace.layer_totals()
    with trace.layer("outer"):
        with trace.layer("inner"):
            pass
    assert trace.layer("a") is trace.layer("b")
    pool = small_pool(pipeline_depth=2)
    for c in range(3):
        pool.commit_async(bumped(pool, c + 1), dirty_pages=[0, 1])
    pool.drain()
    pool.commit(bumped(pool, 5))
    assert trace.layer_totals() == before


def test_nested_spans_count_total_self_and_parent():
    off_span()
    with profiled():
        with trace.layer("a"):
            for _ in range(2):
                with trace.layer("b"):
                    with trace.layer("c"):
                        time.sleep(0.002)
                    time.sleep(0.001)
            time.sleep(0.001)
    t = trace.layer_totals()
    assert set(t) == {"a", "b", "c"}
    assert (t["a"]["n"], t["b"]["n"], t["c"]["n"]) == (1, 2, 2)
    assert (t["a"]["parent"], t["b"]["parent"], t["c"]["parent"]) == \
        (None, "a", "b")
    assert t["a"]["self_ms"] == pytest.approx(
        t["a"]["total_ms"] - t["b"]["total_ms"], abs=1e-9)
    assert t["b"]["self_ms"] == pytest.approx(
        t["b"]["total_ms"] - t["c"]["total_ms"], abs=1e-9)
    assert t["c"]["self_ms"] == t["c"]["total_ms"] >= 4.0
    assert t["b"]["self_ms"] >= 2.0 and t["a"]["self_ms"] >= 1.0


def test_ranges_appear_nested_in_the_profile():
    """Nested as the spans are, and as operator ranges: a profiler mirrors
    a user annotation onto the device's timeline, which would count there
    as device work."""
    off_span()
    with profiled() as prof:
        with trace.layer("outer"):
            with trace.layer("inner"):
                torch.ones(4).add_(1)
    rs = ranges(prof)
    assert sorted(n for n, _, _ in rs) == ["inner", "outer"]
    assert {str(e.activity_type()) for e in
            prof.profiler.kineto_results.events()
            if e.name().startswith(trace.LAYER_PREFIX)} == {"cpu_op"}
    (_, o0, o1), = [r for r in rs if r[0] == "outer"]
    (_, i0, i1), = [r for r in rs if r[0] == "inner"]
    assert o0 <= i0 and i1 <= o1


def test_a_second_session_starts_a_fresh_table():
    off_span()
    with profiled():
        with trace.layer("first"):
            pass
    assert set(trace.layer_totals()) == {"first"}
    off_span()
    assert set(trace.layer_totals()) == {"first"}     # kept for a reader
    with profiled():
        with trace.layer("second"):
            pass
        with trace.layer("second"):
            pass
    t = trace.layer_totals()
    assert set(t) == {"second"} and t["second"]["n"] == 2


# -- the program's spans --------------------------------------------------------


def test_patch_commits_on_one_page_set_build_one_program():
    pool = small_pool()
    off_span()
    with profiled():
        for c in (1, 2):
            pool.commit(bumped(pool, c), dirty_pages=[0, 2])
    t = trace.layer_totals()
    assert t["pool.commit"]["n"] == 2 and t["pool.commit"]["parent"] is None
    assert t["pool.to_zone"]["n"] == 2
    assert t["pool.to_zone"]["parent"] == "pool.commit"
    assert t["txn.commit_program"]["n"] == 2
    assert t["txn.commit_program"]["parent"] == "pool.commit"
    assert t.get("txn.commit_build", {"n": 0})["n"] <= 1
    if "txn.commit_build" in t:
        assert t["txn.commit_build"]["parent"] == "txn.commit_program"


def test_a_full_ring_and_a_drain_wait_under_ring_wait():
    pool = small_pool(pipeline_depth=1)
    off_span()
    with profiled():
        for c in (1, 2, 3):
            pool.commit_async(bumped(pool, c), dirty_pages=[1])
        pool.drain()
    t = trace.layer_totals()
    assert t["pool.commit"]["n"] == 3
    # two forced resolves inside a commit, one drain outside any
    assert t["ring.wait"]["n"] == 3
    assert t["ring.wait"]["parent"] == "pool.commit"


def test_a_served_step_records_decode_and_footprint():
    cfg = ModelConfig(name="t_srv", family="dense", n_layers=2, d_model=32,
                      n_heads=4, n_kv=2, d_ff=64, vocab=128,
                      param_dtype="float32", compute_dtype="float32")
    srv = Server(cfg, ProtectConfig(mode="mlpc", block_words=BW,
                                    scrub_period=2),
                 ZoneMesh((4, 2), ("data", "model")), batch=4, max_len=32,
                 device="cpu")
    srv.start(srv.model.init(torch.Generator().manual_seed(0), "cpu"))
    tok = srv.prefill(torch.zeros(4, 2, dtype=torch.long))
    with profiled() as prof:
        for _ in range(2):
            tok = srv.step(tok)
    t = trace.layer_totals()
    assert t["serve.step"]["n"] == 2 and t["serve.step"]["parent"] is None
    for name in ("serve.decode", "serve.footprint", "pool.commit"):
        assert t[name]["n"] == 2 and t[name]["parent"] == "serve.step", name
    assert t["txn.commit_program"]["parent"] == "pool.commit"
    assert t["scrub"]["parent"] == "serve.step"
    step = t["serve.step"]
    children = sum(v["total_ms"] for v in t.values()
                   if v["parent"] == "serve.step")
    assert step["self_ms"] == pytest.approx(step["total_ms"] - children,
                                            abs=1e-9)
    assert {"serve.step", "serve.decode", "serve.footprint"} <= {
        n for n, _, _ in ranges(prof)}


# -- Tracer.span ----------------------------------------------------------------


def test_tracer_span_is_a_layer_span_with_its_parent():
    tracer = Tracer()
    off_span()
    with profiled() as prof:
        with tracer.span("rescale"):
            with tracer.span("scrub", scope="full"):
                pass
            tracer.emit("note")
    begins = {e["kind"]: e for e in tracer.events if e["ev"] == "begin"}
    assert begins["rescale"]["parent"] is None
    assert begins["scrub"]["parent"] == begins["rescale"]["id"]
    assert begins["scrub"]["scope"] == "full"
    assert validate_events(tracer.events) == []
    assert trace.layer_totals()["scrub"]["parent"] == "rescale"
    assert sorted(n for n, _, _ in ranges(prof)) == ["rescale", "scrub"]
    # with no profiler the events are the same, parents included
    quiet = Tracer()
    with quiet.span("rescale"):
        with quiet.span("scrub", scope="full"):
            pass
    assert [(e["ev"], e["kind"], e.get("parent")) for e in quiet.events] \
        == [(e["ev"], e["kind"], e.get("parent")) for e in tracer.events
            if e["kind"] != "note"]


@pytest.mark.parametrize("fails", ["begin", "end"])
def test_a_tracer_span_that_fails_leaves_no_layer_span_open(fails,
                                                             monkeypatch):
    """A tracer whose begin or end raises (the segment's write) leaves the
    layer spans' stack as it found it: the next span has no stale parent."""
    tracer = Tracer()

    def broken(*a, **k):
        raise OSError("segment write")
    monkeypatch.setattr(tracer, fails, broken)
    off_span()
    with profiled():
        with pytest.raises(OSError):
            with tracer.span("scrub"):
                pass
        assert trace._stack == []
        with trace.layer("after"):
            pass
    t = trace.layer_totals()
    assert t["after"]["parent"] is None
    assert t.get("scrub", {"n": 0})["n"] == (1 if fails == "end" else 0)


@pytest.mark.parametrize("name", [*scenarios.SCENARIOS,
                                  *scenarios.GROUP_SCENARIOS])
def test_chaos_and_ring_traces_stay_valid_under_a_profiler(name):
    off_span()
    with profiled():
        out = scenarios.run_scenario(name, quick=True, device="cpu")
    assert out["golden_exact"] and out["trace"]["violations"] == [], out
    assert trace.layer_totals()
