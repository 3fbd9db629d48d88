"""The chaos campaign (repro_torch.chaos) and the pool plumbing it rides
on: the reference's tests/test_chaos.py cases that need no Trainer, run on
the port; the traffic step bit-equal to the reference's jitted step (a
fused multiply-add); `inject_event` byte-equal to the reference's for each
fault kind; a whole scenario's final state bit-equal to the reference's
run on Auto meshes; `attach_schedule` on a stub host; fault-id linkage in
the trace; the quick campaign and `python -m repro_torch.chaos --smoke`.

The load-bearing invariant everywhere: a fault recovered mid-traffic must
leave the state bit-identical to the fault-free golden run.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.chaos import runner as ref_runner
from repro.chaos import scenarios as ref_scenarios
from repro.chaos import workload as ref_workload
from repro.chaos.schedule import ChaosEvent as RefEvent
from repro.configs.base import ProtectConfig as RefConfig
from repro.pool import Pool as RefPool
from repro_torch import Fault, Pool, ProtectConfig
from repro_torch.chaos import scenarios
from repro_torch.chaos.runner import (ScenarioRunner, attach_schedule,
                                      inject_event)
from repro_torch.chaos.schedule import ChaosEvent, FaultSchedule
from repro_torch.chaos.workload import (GAIN, PoolWorkload, fma,
                                        initial_state)
from repro_torch.dist.straggler import StragglerPolicy
from repro_torch.obs import validate_events
from repro_torch.runtime import failure
from tests._torch_ref import (assert_prot_same, jax_mesh, jax_specs,
                              port_specs, small_state_np, to_jax, to_torch,
                              zone_mesh)

E = ChaosEvent.make
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _wl(mesh="mesh42", *, window=4, redundancy=2, seed=3, **cfg_kw):
    cfg = ProtectConfig(mode="mlpc", window=window, redundancy=redundancy,
                        block_words=64, **cfg_kw)
    return PoolWorkload(zone_mesh(mesh), cfg, n_bytes=1 << 14, seed=seed,
                        device="cpu")


# -- mid-window fault arrival x engines x stack heights -----------------------

@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("red", [1, 2, 3])
def test_midwindow_loss_recovers_to_golden(window, red):
    """A rank loss at the in-window arrival point, recovered online, ends
    bit-identical to the fault-free run — for the synchronous engine and
    mid-window in the deferred engine, at every r."""
    wl = _wl(window=window, redundancy=red)
    sched = FaultSchedule([E(2, "rank_loss", mid_window=True, rank=1)],
                          seed=7)
    out = ScenarioRunner(wl, sched).run(6)
    assert out["golden_exact"], out
    (rec,) = out["recoveries"]
    assert rec["kind"] == "rank_loss" and rec["verified"]
    assert rec["reverified"] is True
    assert validate_events(wl.pool.tracer.events) == []


def test_midwindow_scribble_plus_loss_escape_hatch():
    """Scribble on rank 0 concurrent with rank 2's loss inside one window:
    the runner folds both into a multi_loss through the r = 2 stack."""
    wl = _wl(window=8, redundancy=2)
    sched = FaultSchedule([
        E(3, "scribble", mid_window=True, rank=0, n_words=5),
        E(3, "rank_loss", mid_window=True, rank=2),
    ], seed=11)
    out = ScenarioRunner(wl, sched).run(8)
    assert out["golden_exact"], out
    (rec,) = out["recoveries"]
    assert rec["kind"] == "multi_loss" and rec["verified"]


def test_budget_exhaust_then_rearm():
    """e = 2 on an r = 1 pool trips the budget error; the runner restores
    the snapshot and replays; a later single loss recovers online again —
    and the whole run still ends golden."""
    wl = _wl(window=2, redundancy=1)
    sched = FaultSchedule([
        E(1, "snapshot"),
        E(3, "multi_loss", e=2),
        E(6, "rank_loss"),
    ], seed=5)
    out = ScenarioRunner(wl, sched).run(9)
    assert out["golden_exact"], out
    kinds = [r["kind"] for r in out["recoveries"]]
    assert kinds == ["restore_replay", "rank_loss"]
    assert "syndrome budget exhausted" in out["recoveries"][0]["error"]
    assert validate_events(wl.pool.tracer.events) == []


def test_rescale_under_traffic_stays_golden():
    wl = _wl(window=4, redundancy=2)
    sched = FaultSchedule([
        E(2, "rescale", shape=(8, 1)),
        E(4, "rank_loss"),
        E(6, "rescale", shape=(4, 2)),
    ], seed=13)
    out = ScenarioRunner(wl, sched).run(9)
    assert out["golden_exact"], out
    kinds = [r["kind"] for r in out["recoveries"]]
    assert kinds == ["rescale", "rank_loss", "rescale"]
    assert wl.pool.protector.group_size == 4


# -- pool plumbing: arrival hook, re-entry, budget error, re-verify -----------

def _pool(**cfg_kw):
    state, specs = small_state_np()
    base = dict(mode="mlpc", block_words=64)
    base.update(cfg_kw)
    return Pool.open(to_torch(state), port_specs(specs),
                     mesh=zone_mesh("mesh42"), config=ProtectConfig(**base),
                     device="cpu")


def _evolve(cur):
    return {k: (v.float() * 1.01 + 0.003).to(v.dtype) for k, v in cur.items()}


def test_arrival_hook_fires_between_commit_and_flush():
    pool = _pool(window=4)
    seen = []
    pool.set_arrival_hook(
        lambda prot, since, at_boundary:
            (seen.append((since, at_boundary)), None)[1])
    for _ in range(4):
        pool.commit(_evolve(pool.state))
    assert seen == [(1, False), (2, False), (3, False), (4, True)]
    pool.set_arrival_hook(None)
    pool.commit(_evolve(pool.state))
    assert len(seen) == 4


def test_arrival_hook_sync_engine_every_commit():
    pool = _pool(window=1)
    seen = []
    pool.set_arrival_hook(
        lambda prot, since, at_boundary:
            (seen.append((since, at_boundary)), None)[1])
    pool.commit(_evolve(pool.state))
    pool.commit_async(_evolve(pool.state)).result()
    assert seen == [(1, True), (1, True)]


def test_recover_reentry_queues_and_drains():
    """A fault arriving during recovery (via the freeze callback) is
    queued, drained after the running reconstruction, counted in the outer
    report's followups — and the fault noted meanwhile links to the
    follow-up's span."""
    box = {}

    def freeze():
        pool = box["pool"]
        if not box.get("fired"):
            box["fired"] = True
            box["fid"] = pool.note_fault("scribble", pages=[[0, 0]])
            assert pool.recover(Fault.scribble(0, [0])) is None

    state, specs = small_state_np()
    pool = Pool.open(to_torch(state), port_specs(specs),
                     mesh=zone_mesh("mesh42"),
                     config=ProtectConfig(mode="mlpc", block_words=64),
                     on_freeze=freeze, device="cpu")
    box["pool"] = pool
    before = pool.state
    ev = pool.inject(lambda p, prot: failure.inject_rank_loss(p, prot, 1))
    rep = pool.recover(Fault.from_event(ev))
    assert rep.followups == 1
    assert rep.verified and rep.reverified
    for k, v in before.items():
        assert torch.equal(pool.state[k], v), k
    events = pool.tracer.events
    assert validate_events(events) == []
    spans = [e for e in events if e["kind"] == "recovery" and e["ev"] ==
             "begin"]
    assert [s["faults"] for s in spans] == [[0], [box["fid"]]]


def test_budget_exhausted_error_is_actionable():
    pool = _pool(redundancy=1)
    pool.prot, ev = failure.inject_multi_rank_loss(
        pool.protector, pool.prot, (0, 2))
    with pytest.raises(RuntimeError) as err:
        pool.recover(Fault.from_event(ev))
    msg = str(err.value)
    assert "syndrome budget exhausted" in msg
    assert "[0, 2]" in msg                   # names the dead ranks
    assert "redundancy=1" in msg             # names the available budget
    assert "pool.init" in msg                # names the re-arm path


def test_post_recovery_reverify_flags_residual_corruption():
    """r = 1: a scribble outstanding on rank 0 while rank 2 is rebuilt
    poisons the reconstruction; the post-recovery re-verify surfaces it."""
    pool = _pool(redundancy=1)
    pool.prot, _ = failure.inject_scribble(pool.protector, pool.prot,
                                           rank=0, word_offsets=[5])
    pool.prot, ev = failure.inject_rank_loss(pool.protector, pool.prot, 2)
    rep = pool.recover(Fault.from_event(ev))
    assert rep.reverified is False
    assert rep.verified is False             # folded into the verdict


def test_pool_inject_preserves_open_window():
    """Pool.inject keeps the deferred window's accumulator: corrupt
    mid-window, recover, and the flushed state still matches a clean run
    of the same commits."""
    pool = _pool(window=4, redundancy=2)
    ref = _pool(window=4, redundancy=2)
    for _ in range(2):                        # window half-open
        pool.commit(_evolve(pool.state))
        ref.commit(_evolve(ref.state))
    acc = pool._est.acc
    ev = pool.inject(lambda p, prot: failure.inject_rank_loss(p, prot, 3))
    assert pool._est.acc is acc and pool.engine.needs_flush
    rep = pool.recover(Fault.from_event(ev))
    assert rep.verified and rep.reverified
    for k, v in ref.state.items():
        assert torch.equal(pool.state[k], v), k


# -- seeded injectors + Fault.from_event taxonomy -----------------------------

def test_seeded_injectors_are_deterministic():
    pool_a, pool_b = _pool(), _pool()
    plan = failure.scribble_plan(pool_a.protector, seed=42, n_words=4)
    assert plan == failure.scribble_plan(pool_b.protector, seed=42,
                                         n_words=4)
    assert plan != failure.scribble_plan(pool_a.protector, seed=43,
                                         n_words=4)
    pa, ev_a = failure.seeded_scribble(pool_a.protector, pool_a.prot, seed=42)
    pb, ev_b = failure.seeded_scribble(pool_b.protector, pool_b.prot, seed=42)
    assert ev_a.locations == ev_b.locations
    for k in pa.state:
        assert torch.equal(pa.state[k], pb.state[k]), k
    _, ev_r = failure.seeded_rank_loss(pool_a.protector, pa, seed=9)
    _, ev_r2 = failure.seeded_rank_loss(pool_b.protector, pb, seed=9)
    assert ev_r.lost_rank == ev_r2.lost_rank
    _, ev_m = failure.seeded_multi_rank_loss(pool_a.protector, pa, seed=9,
                                             e=2)
    _, ev_m2 = failure.seeded_multi_rank_loss(pool_b.protector, pb, seed=9,
                                              e=2)
    assert ev_m.lost_ranks == ev_m2.lost_ranks


def test_fault_from_event_covers_every_kind():
    ev = failure.FailureEvent("rank_loss", lost_rank=2)
    assert Fault.from_event(ev) == Fault.rank_loss(2)
    ev = failure.FailureEvent("multi_loss", lost_ranks=[3, 1])
    assert Fault.from_event(ev) == Fault.multi_loss(1, 3)
    ev = failure.FailureEvent("double_loss", lost_ranks=[0, 2])
    assert Fault.from_event(ev) == Fault.double_loss(0, 2)
    ev = failure.FailureEvent("scribble", locations=[(1, 4), (1, 7)])
    assert Fault.from_event(ev) == Fault.scribble(1, [4, 7])
    with pytest.raises(ValueError, match="canary"):
        Fault.from_event(failure.FailureEvent("canary"))


# -- straggler wiring ---------------------------------------------------------

def test_straggler_collapses_window_then_regrows():
    state, specs = small_state_np()
    cfg = ProtectConfig(mode="mlpc", block_words=64, window=8,
                        straggler_threshold=2.0, window_growth_commits=2)
    pool = Pool.open(to_torch(state), port_specs(specs),
                     mesh=zone_mesh("mesh42"), config=cfg, device="cpu",
                     straggler_policy=StragglerPolicy(4, threshold=2.0,
                                                      window=2))
    assert pool.engine.window == 8
    slow = np.asarray([0.01, 0.08, 0.01, 0.01])
    for _ in range(2):
        pool.commit(_evolve(pool.state))
        pool.observe_commit_times(slow)
    assert pool.dropped_replicas == [1]
    assert pool.engine.window == 1            # degraded: collapsed
    healthy = np.full(4, 0.01)
    for _ in range(2):                        # slide the slow samples out
        pool.observe_commit_times(healthy)
    assert pool.dropped_replicas == []
    for _ in range(8):                        # clean commits regrow
        pool.commit(_evolve(pool.state))
    assert pool.engine.window > 1


def test_straggler_threshold_validation():
    with pytest.raises(ValueError, match="straggler_threshold"):
        ProtectConfig(straggler_threshold=-1.0)


# -- against the reference ------------------------------------------------------

def test_traffic_step_matches_the_reference_jitted_step():
    """The initial state and 40 steps of the recurrence, bit for bit: the
    reference's jitted `w * GAIN + c` is one fused multiply-add; two
    roundings (eager `w * GAIN + c`) drift from it at once."""
    n = 1 << 18
    want = ref_workload._initial_host_state(n, 5)
    got = initial_state(n, 5, "cpu")
    assert np.array_equal(got.numpy(), want)
    step = jax.jit(lambda s, c: s * ref_workload.GAIN + c)
    w, t = jax.numpy.asarray(want), got
    two = got.clone()
    for i in range(40):
        c = np.float32(i % 7) * ref_workload.STEP_BIAS
        w = step(w, jax.numpy.float32(c))
        t = fma(t, GAIN, c)
        two = two * float(GAIN) + float(c)
        assert np.array_equal(t.numpy(), np.asarray(w)), i
    assert not torch.equal(two, t)


@pytest.mark.parametrize("kind,args", [
    ("rank_loss", {}), ("rank_loss", {"rank": 3}), ("multi_loss", {"e": 2}),
    ("multi_loss", {"ranks": [0, 3]}), ("scribble", {"n_words": 6}),
    ("scribble", {"rank": 1})])
def test_inject_event_matches_the_reference(kind, args):
    mesh = jax_mesh("mesh42")
    state, specs = small_state_np()
    cfg = dict(mode="mlpc", redundancy=2, block_words=64)
    ref = RefPool.open(to_jax(state, specs, mesh), jax_specs(specs),
                       mesh=mesh, config=RefConfig(**cfg))
    port = Pool.open(to_torch(state), port_specs(specs),
                     mesh=zone_mesh("mesh42"), config=ProtectConfig(**cfg),
                     device="cpu")
    rprot, rev = ref_runner.inject_event(
        ref.protector, ref.prot, RefEvent.make(3, kind, **args), 77)
    pprot, pev = inject_event(port.protector, port.prot,
                              E(3, kind, **args), 77)
    assert_prot_same(rprot, mesh, pprot)
    assert dataclasses.asdict(pev) == {
        k: ([tuple(x) for x in v] if k == "locations" and v else v)
        for k, v in dataclasses.asdict(rev).items()}


def _auto_make_mesh(make_mesh):
    def auto(shape, axes, **kw):
        kw.setdefault("axis_types", (AxisType.Auto,) * len(axes))
        return make_mesh(shape, axes, **kw)
    return auto


def test_a_scenario_ends_bit_equal_to_the_reference(monkeypatch):
    """rescale_under_traffic (G = 4 -> 8 -> 4, a rank loss between), run
    by the reference on Auto meshes and by the port: the same final
    state, the same recoveries, both golden."""
    monkeypatch.setattr(jax, "make_mesh", _auto_make_mesh(jax.make_mesh))
    rwl, rsched, n = ref_scenarios.rescale_under_traffic(True, 4)
    rout = ref_runner.ScenarioRunner(rwl, rsched).run(n, golden=False)
    pwl, psched, pn = scenarios.rescale_under_traffic(True, 4,
                                                      device="cpu")
    pout = ScenarioRunner(pwl, psched).run(pn)
    assert pn == n and pout["golden_exact"]
    want = np.asarray(jax.device_get(rwl.final_host()["w"]))
    assert np.array_equal(pwl.final_host()["w"].numpy(), want)
    assert [(r["kind"], r.get("lost_rank"), r.get("verified"))
            for r in pout["recoveries"]] == \
        [(r["kind"], r.get("lost_rank"), r.get("verified"))
         for r in rout["recoveries"]]
    assert_prot_same(rwl.pool.prot, rwl.mesh, pwl.pool.prot)


# -- runtime attachment ---------------------------------------------------------

class StubHost:
    """The duck type `attach_schedule` rides on: `pool`, `add_step_hook`
    and a straggler feed."""

    def __init__(self, pool):
        self.pool = pool
        self.hooks = []
        self.replica_slowdown = np.ones(4)

    def add_step_hook(self, fn):
        self.hooks.append(fn)

    def run(self, n):
        for _ in range(n):
            ok = self.pool.commit(_evolve(self.pool.state))
            out = {"committed": bool(ok)}
            for fn in self.hooks:
                fn(self, out)


def test_attach_schedule_on_a_stub_host():
    host = StubHost(_pool(window=4, redundancy=2))
    want = host.pool.state
    log = attach_schedule(host, FaultSchedule([
        E(1, "rank_loss", rank=2), E(2, "straggler_start", rank=3),
        E(3, "scribble", rank=1), E(4, "straggler_stop")], seed=0))
    host.run(2)
    assert len(log) == 1
    rec = log[0]
    assert rec["step"] == 1 and rec["kind"] == "rank_loss"
    assert rec["verified"] is True and rec["reverified"] is True
    assert rec["lost_rank"] == 2
    assert rec["solve_ms"] >= 0 and rec["total_ms"] >= rec["solve_ms"]
    host.run(1)
    assert host.replica_slowdown.tolist() == [1, 1, 1, 6.0]
    host.run(2)
    assert [r["kind"] for r in log] == ["rank_loss", "straggler_start",
                                        "scribble", "straggler_stop"]
    assert host.replica_slowdown.tolist() == [1] * 4
    assert validate_events(host.pool.tracer.events) == []
    # the state after five evolve steps, the faults recovered on the way
    for _ in range(5):
        want = _evolve(want)
    host.pool.flush()
    for k, v in want.items():
        assert torch.equal(host.pool.state[k], v), k
    unprotected = StubHost(None)
    attach_schedule(unprotected, FaultSchedule([E(0, "rank_loss")]))
    unprotected.hooks[0](unprotected, {})          # nothing to inject into
    bad = StubHost(_pool())
    attach_schedule(bad, FaultSchedule([E(0, "rescale", shape=(8, 1))]))
    with pytest.raises(ValueError, match="rescale"):
        bad.run(1)


# -- trace linkage, the campaign, the CLI ---------------------------------------

def test_a_repairing_scrub_links_the_injected_fault():
    pool = _pool(window=4)
    pool.commit(_evolve(pool.state))
    ev = pool.inject(lambda p, prot: failure.inject_scribble(
        p, prot, rank=1, word_offsets=[3]))
    fid = [e for e in pool.tracer.events if e["kind"] == "fault"][-1]["id"]
    report = pool.scrub()
    assert report.repaired and report.bad_locations == ev.locations
    end = [e for e in pool.tracer.events
           if e["kind"] == "scrub" and e["ev"] == "end"][-1]
    assert end["faults"] == [fid]
    assert validate_events(pool.tracer.events) == []
    assert pool.metrics.counter("pool_faults_total",
                                kind="scribble").value == 1


def test_quick_campaign_is_golden_with_valid_traces(tmp_path):
    results = scenarios.campaign(quick=True, device="cpu",
                                 trace_dir=str(tmp_path))
    assert [r["scenario"] for r in results] == [
        *scenarios.SCENARIOS, *scenarios.GROUP_SCENARIOS,
        "storm_r1_w1", "storm_r2_w16"]
    for r in results:
        assert r["golden_exact"] and r["trace"]["violations"] == [], r
        assert os.path.exists(r["trace"]["path"])
    by = {r["scenario"]: r for r in results}
    wt = by["straggler"]["window_trace"]
    assert (wt["min_window"], wt["max_dropped"], wt["final_dropped"]) == \
        (1, 1, 0)
    assert [r["kind"] for r in by["budget_exhaust_rearm"]["recoveries"]] \
        == ["restore_replay", "rank_loss"]


def test_chaos_cli_smoke_exits_0():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.chaos", "--smoke", "--device",
         "cpu"], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert '"golden_exact": true' in out.stdout
    assert '"trace_violations": []' in out.stdout
