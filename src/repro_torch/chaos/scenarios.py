"""The chaos campaign: named scenarios over the ScenarioRunner.

Each builder returns (workload, schedule, n_steps); `run_scenario` executes
one and `campaign` runs the whole set.  Every scenario ends with the golden
bit-identity check — chaos may cost latency, never bytes — and with the
validation of its trace: every scenario traces into a `Tracer` (in memory,
or a JSONL file under `trace_dir`) and the result carries
`validate_events`' verdict, so a campaign whose trace does not link every
fault to its recovery is reported broken where it ran.

The reference's meshes are (4, 2) and (8, 1), so both zone geometries
(G = 4, G = 8) see traffic.  Every builder takes them as `meshes=(first,
second)`, with its byte size (`n_bytes`) and its `device`, so that the same
schedules run at another width: (50, 2) and (100, 1) over 1,064,960,000
bytes on the card (chip_smoke.py).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.chaos.runner import ScenarioRunner, trees_equal
from repro_torch.chaos.schedule import ChaosEvent, FaultSchedule
from repro_torch.chaos.workload import (GAIN, PoolWorkload, fma,
                                       initial_state, n_words, sync)
from repro_torch.configs.base import ProtectConfig
from repro_torch.dist.sharding import P, ZoneMesh
from repro_torch.obs import Tracer, validate_events

E = ChaosEvent.make
MESHES = ((4, 2), (8, 1))


def _mesh(shape) -> ZoneMesh:
    return ZoneMesh(tuple(shape), ("data", "model"))


def _cfg(**kw) -> ProtectConfig:
    base = dict(mode="mlpc", window=4, redundancy=2, scrub_period=0)
    base.update(kw)
    return ProtectConfig(**base)


def _tracer(trace_dir: Optional[str], name: str) -> Tracer:
    """The scenario's trace sink: a JSONL file under `trace_dir`, else in
    memory."""
    if not trace_dir:
        return Tracer()
    os.makedirs(trace_dir, exist_ok=True)
    return Tracer(os.path.join(trace_dir, f"{name}.trace.jsonl"))


def _trace_verdict(tracer: Tracer) -> dict:
    out = {"path": tracer.path, "events": len(tracer.events),
           "violations": validate_events(tracer.events)}
    tracer.close()
    return out


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if xs else None


# -- builders: name -> (workload, schedule, n_steps) --------------------------


def rescale_under_traffic(quick: bool, seed: int, *, meshes=MESHES,
                          n_bytes: int = 1 << 15, device=None):
    """Elastic first -> second -> first mesh ((4, 2) -> (8, 1) -> (4, 2))
    while commits keep flowing, with a rank loss landing right after the
    first rescale settles."""
    n = 24 if quick else 60
    wl = PoolWorkload(_mesh(meshes[0]), _cfg(), n_bytes=n_bytes, seed=seed,
                      device=device)
    sched = FaultSchedule([
        E(n // 4, "rescale", shape=tuple(meshes[1])),
        E(n // 4 + 2, "rank_loss"),
        E(n // 2, "rescale", shape=tuple(meshes[0])),
    ], seed=seed)
    return wl, sched, n


def straggler(quick: bool, seed: int, *, meshes=MESHES,
              n_bytes: int = 1 << 15, device=None):
    """One replica runs 6x slow mid-run: the policy drops it, the adaptive
    window collapses while degraded, and regrows after the replica
    heals."""
    from repro_torch.dist.straggler import StragglerPolicy
    n = 36 if quick else 80
    cfg = _cfg(window=8, straggler_threshold=2.0, window_growth_commits=4)
    mesh = _mesh(meshes[0])
    policy = StragglerPolicy(mesh.group_size, threshold=2.0, window=4)
    wl = PoolWorkload(mesh, cfg, n_bytes=n_bytes, seed=seed,
                      straggler_policy=policy, device=device)
    sched = FaultSchedule([
        E(n // 4, "straggler_start", rank=1, factor=6.0),
        E(n // 2, "straggler_stop"),
    ], seed=seed)
    return wl, sched, n


def midwindow_scribble_loss(quick: bool, seed: int, *, meshes=MESHES,
                            n_bytes: int = 1 << 15, device=None):
    """A scribble on one rank concurrent with another rank's loss, both
    landing INSIDE an open window — the overlap single parity cannot
    untangle; the r = 2 syndrome stack solves both as losses."""
    n = 20 if quick else 48
    wl = PoolWorkload(_mesh(meshes[0]), _cfg(window=8), n_bytes=n_bytes,
                      seed=seed, device=device)
    sched = FaultSchedule([
        E(n // 2, "scribble", mid_window=True, rank=0, n_words=6),
        E(n // 2, "rank_loss", mid_window=True, rank=2),
    ], seed=seed)
    return wl, sched, n


def budget_exhaust_rearm(quick: bool, seed: int, *, meshes=MESHES,
                         n_bytes: int = 1 << 15, device=None):
    """Back-to-back losses beyond the stack: e = 2 on an r = 1 pool raises
    the budget-exhausted error, the runner restores + replays from the
    snapshot tier, and a later single loss again recovers online."""
    n = 24 if quick else 48
    wl = PoolWorkload(_mesh(meshes[0]), _cfg(redundancy=1, window=2),
                      n_bytes=n_bytes, seed=seed, device=device)
    sched = FaultSchedule([
        E(n // 4, "snapshot"),
        E(n // 3, "multi_loss", e=2),           # e > r: exhausted
        E(2 * n // 3, "rank_loss"),             # re-armed: online again
    ], seed=seed)
    return wl, sched, n


def crash_replay_storm(r: int, window: int):
    """One storm cell: an e = r loss (the stack's full budget) plus a
    mid-window single loss, at syndrome height r and window W; r = 4 runs
    on the second mesh (r <= G - 1)."""
    def build(quick: bool, seed: int, *, meshes=MESHES,
              n_bytes: int = 1 << 15, device=None):
        n = 16 if quick else 40
        shape = meshes[1] if r >= 4 else meshes[0]
        wl = PoolWorkload(_mesh(shape), _cfg(redundancy=r, window=window),
                          n_bytes=n_bytes, seed=seed, device=device)
        events = [E(n // 3, "rank_loss", mid_window=(window > 1))]
        if r >= 2:
            events.append(E(2 * n // 3, "multi_loss", e=r))
        return wl, FaultSchedule(events, seed=seed), n
    return build


def multi_tenant_interference(quick: bool, seed: int,
                              trace_dir: Optional[str] = None, *,
                              meshes=MESHES, n_bytes: int = 1 << 14,
                              device=None) -> dict:
    """Interference under multi-tenancy: a PoolGroup of four same-cohort
    tenants commits batched waves while tenant 0 is scribbled, put through
    a quarantined recovery, and the shared scrub scheduler keeps
    one-pool-per-wave verification pressure on the whole group.  The
    neighbours must (a) end bit-identical to a fault-free reference group
    run and (b) keep committing through the victim's quarantine window."""
    from repro_torch.pool import Fault
    from repro_torch.runtime import failure
    from repro_torch.tenancy import PoolGroup

    n = 24 if quick else 60
    n_t = 4
    mesh = _mesh(meshes[0])
    cfg = _cfg(window=1)                      # sync: one dispatch a wave

    def build_group(tracer=None):
        grp = PoolGroup(mesh, scrub_page_budget=0, tracer=tracer,
                        device=device)
        words = n_words(n_bytes, mesh.group_size)
        for t in range(n_t):
            state = {"w": initial_state(words, seed + 13 * t, grp.device)}
            grp.admit(f"t{t}", state, {"w": P("data")}, config=cfg)
        return grp

    tracer = _tracer(trace_dir, "multi_tenant_interference")
    grp = build_group(tracer)
    ref = build_group()
    tids = grp.tenants

    def wave(g, i, interfere: bool) -> float:
        c = np.float32((i % 7) * 1e-6)
        ups = {tid: {"w": fma(g[tid].pool.state["w"], GAIN, c)}
               for tid in tids}
        t0 = time.perf_counter()
        g.commit(ups, data_cursor=i)
        sync(g.device)
        wall = (time.perf_counter() - t0) * 1e3
        if interfere:
            budget = g["t0"].pool.scrubber.pool_pages
            g.scrub_tick(page_budget=budget)
        return wall

    base_ms, intf_ms, recoveries = [], [], []
    for i in range(n):
        interfere = n // 3 <= i < 2 * n // 3
        (intf_ms if interfere else base_ms).append(wave(grp, i, interfere))
        wave(ref, i, False)
        if i == n // 3:
            # scribble t0 mid-campaign; the quarantined recovery runs while
            # the other three tenants' traffic keeps flowing
            grp["t0"].pool.inject(
                lambda p, pr: failure.inject_scribble(
                    p, pr, rank=1, word_offsets=range(6)))
            t_r = time.perf_counter()
            rep = grp.recover("t0", Fault.scribble(1, [0]))
            sync(grp.device)
            recoveries.append({
                "kind": "scribble", "tenant": "t0",
                "verified": bool(rep.verified),
                "ms": (time.perf_counter() - t_r) * 1e3})

    golden = all(trees_equal(grp[tid].pool.state, ref[tid].pool.state)
                 for tid in tids)
    rec_ms = [r["ms"] for r in recoveries]
    return {
        "scenario": "multi_tenant_interference",
        "golden_exact": bool(golden),
        "steps": n,
        "events": len(recoveries),
        "r": cfg.redundancy,
        "window": cfg.window,
        "tenants": n_t,
        "quarantined_during_run": True,
        "commit_ms": {
            "clean": {"p50_ms": _pct(base_ms, 50),
                      "p99_ms": _pct(base_ms, 99)},
            "during": {"p50_ms": _pct(intf_ms, 50),
                       "p99_ms": _pct(intf_ms, 99)}},
        "recovery_ms": {"p50_ms": _pct(rec_ms, 50),
                        "p99_ms": _pct(rec_ms, 99)},
        "recoveries": recoveries,
        "scheduler": grp.scheduler.stats(),
        "health": grp.health(),
        "trace": _trace_verdict(tracer),
    }


def fault_with_inflight_commits(quick: bool, seed: int,
                                trace_dir: Optional[str] = None, *,
                                meshes=MESHES, n_bytes: int = 1 << 15,
                                device=None) -> dict:
    """Faults landing while the commit ring holds unresolved tickets.

    A rank loss lands with k = 2 tickets in flight and a scribble with
    k = depth (a full ring), on a deferred-window pool at
    pipeline_depth = 4.  Recovery must (a) drain the ring
    deterministically — every in-flight ticket resolves, in dispatch
    order, before reconstruction touches the state — and (b) end
    golden-exact against a fault-free reference that resolved every
    commit synchronously: the pipeline may only ever reorder verdict
    fetches, never commit effects."""
    from repro_torch.pool import Fault
    from repro_torch.runtime import failure

    n = 24 if quick else 60
    depth = 4
    mesh = _mesh(meshes[0])
    cfg = _cfg(window=4, pipeline_depth=depth)
    wl = PoolWorkload(mesh, cfg, n_bytes=n_bytes, seed=seed, device=device)
    ref = PoolWorkload(mesh, cfg, n_bytes=n_bytes, seed=seed, device=device)
    tracer = _tracer(trace_dir, "fault_with_inflight_commits")
    wl.pool.set_tracer(tracer)

    def dispatch_async(w) -> tuple:
        """One commit of traffic through the ring, its verdict left
        unresolved (traffic_step's async twin: the same recurrence)."""
        new_state = w.next_state()
        t0 = time.perf_counter()
        tkt = w.pool.commit_async(new_state, data_cursor=w.t)
        wall = (time.perf_counter() - t0) * 1e3
        w.t += 1
        return tkt, wall

    # fault step -> (fault kind, tickets left unresolved at injection)
    inflight_at = {n // 3: ("rank_loss", 2), 2 * n // 3: ("scribble", depth)}
    tickets, recoveries = [], []
    base_ms, during_ms = [], []
    hot = set()                      # steps whose dispatch rode a recovery
    for f in inflight_at:
        hot.update(range(f, min(f + 3, n)))
    i = 0
    while i < n:
        if i in inflight_at:
            kind, k = inflight_at[i]
            # build exactly k unresolved tickets: drain to empty, then
            # dispatch k commits without touching a verdict
            wl.pool.drain()
            burst = []
            for _ in range(k):
                tkt, wall = dispatch_async(wl)
                ref.traffic_step()
                burst.append(tkt)
                during_ms.append(wall)
                i += 1
            if wl.pool.in_flight != k:
                raise AssertionError(f"{wl.pool.in_flight} in flight, "
                                     f"not {k}")
            if kind == "rank_loss":
                wl.pool.inject(lambda p, pr: failure.inject_rank_loss(
                    p, pr, rank=1))
                fault = Fault.rank_loss(1)
            else:
                wl.pool.inject(lambda p, pr: failure.inject_scribble(
                    p, pr, rank=2, word_offsets=range(6)))
                fault = Fault.scribble(2, [0])
            t_r = time.perf_counter()
            rep = wl.pool.recover(fault)
            sync(wl.device)
            rec_wall = (time.perf_counter() - t_r) * 1e3
            # the recovery boundary drained the ring: every ticket the fault
            # caught in flight resolved True (the commits were clean; only
            # the state was corrupted afterwards)
            if not (all(t.resolved and t.result() for t in burst)
                    and wl.pool.in_flight == 0):
                raise AssertionError("recovery left tickets unresolved")
            recoveries.append({
                "kind": kind, "inflight_at_fault": k,
                "verified": bool(rep.verified), "ms": rec_wall})
            tickets += burst
        else:
            tkt, wall = dispatch_async(wl)
            ref.traffic_step()
            (during_ms if i in hot else base_ms).append(wall)
            tickets.append(tkt)
            i += 1
    wl.pool.drain()
    wl.pool.flush()
    ref.pool.flush()
    if not all(t.resolved and t.result() for t in tickets):
        raise AssertionError("a ticket did not resolve True")

    golden = trees_equal(wl.pool.state, ref.pool.state)
    rec_ms = [r["ms"] for r in recoveries]
    return {
        "scenario": "fault_with_inflight_commits",
        "golden_exact": bool(golden),
        "steps": n,
        "events": len(recoveries),
        "r": cfg.redundancy,
        "window": cfg.window,
        "pipeline_depth": depth,
        "commit_ms": {
            "clean": {"p50_ms": _pct(base_ms, 50),
                      "p99_ms": _pct(base_ms, 99)},
            "during": {"p50_ms": _pct(during_ms, 50),
                       "p99_ms": _pct(during_ms, 99)}},
        "recovery_ms": {"p50_ms": _pct(rec_ms, 50),
                        "p99_ms": _pct(rec_ms, 99)},
        "recoveries": recoveries,
        "health": wl.pool.health().to_dict(),
        "trace": _trace_verdict(tracer),
    }


SCENARIOS: Dict[str, Callable] = {
    "rescale_under_traffic": rescale_under_traffic,
    "straggler": straggler,
    "midwindow_scribble_loss": midwindow_scribble_loss,
    "budget_exhaust_rearm": budget_exhaust_rearm,
}

# group scenarios run their own loop (a PoolGroup is not a single-pool
# workload) but return the same result-dict shape
GROUP_SCENARIOS: Dict[str, Callable] = {
    "multi_tenant_interference": multi_tenant_interference,
    "fault_with_inflight_commits": fault_with_inflight_commits,
}

# the storm matrix (r x W cells); a quick campaign runs the first two
STORM_CELLS: Tuple[Tuple[int, int], ...] = (
    (1, 1), (2, 16), (3, 16), (4, 16))


def _run(wl, sched, n: int, name: str, trace_dir: Optional[str]) -> dict:
    """Execute one built scenario, its pool tracing into `_tracer`."""
    tracer = _tracer(trace_dir, name)
    wl.pool.set_tracer(tracer)
    out = ScenarioRunner(wl, sched).run(n)
    out["scenario"] = name
    out["trace"] = _trace_verdict(tracer)
    return out


def run_scenario(name: str, *, quick: bool = True, seed: int = 0,
                 trace_dir: Optional[str] = None, **size) -> dict:
    """One named scenario; `size` (meshes, n_bytes, device) goes to its
    builder."""
    if name in GROUP_SCENARIOS:
        return GROUP_SCENARIOS[name](quick, seed, trace_dir, **size)
    wl, sched, n = SCENARIOS[name](quick, seed, **size)
    return _run(wl, sched, n, name, trace_dir)


def run_storm_cell(r: int, window: int, *, quick: bool = True,
                   seed: int = 0, trace_dir: Optional[str] = None,
                   **size) -> dict:
    wl, sched, n = crash_replay_storm(r, window)(quick, seed, **size)
    return _run(wl, sched, n, f"storm_r{r}_w{window}", trace_dir)


def check_results(results: list) -> None:
    """Raise unless every scenario ended golden-exact with a valid trace."""
    bad = [r["scenario"] for r in results if not r.get("golden_exact")]
    if bad:
        raise AssertionError(
            f"chaos scenarios ended non-golden: {bad} — recovered state "
            "must be bit-identical to the fault-free run")
    broken = [r["scenario"] for r in results if r["trace"]["violations"]]
    if broken:
        raise AssertionError(
            f"chaos traces failed validation: {broken} — every fault must "
            "link to the recovery span that resolved it")


def campaign(*, quick: bool = True, seed: int = 0, storms: bool = True,
             trace_dir: Optional[str] = None, device=None) -> list:
    """The full campaign: the core scenarios plus the storm matrix.  Raises
    if any scenario fails the golden bit-identity check — a chaos campaign
    whose end state drifted measured nothing — or emits a trace that fails
    validation."""
    results = [run_scenario(name, quick=quick, seed=seed,
                            trace_dir=trace_dir, device=device)
               for name in (*SCENARIOS, *GROUP_SCENARIOS)]
    if storms:
        cells = STORM_CELLS[:2] if quick else STORM_CELLS
        results += [run_storm_cell(r, w, quick=quick, seed=seed,
                                   trace_dir=trace_dir, device=device)
                    for r, w in cells]
    check_results(results)
    return results
