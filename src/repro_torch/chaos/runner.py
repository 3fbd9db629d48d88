"""ScenarioRunner: drive traffic while a fault schedule fires.

Event timing model (one `step` = one committed transaction):

  * control events (`rescale`, `straggler_*`, `snapshot`) fire BEFORE
    step t's commit;
  * between-commit faults (mid_window=False) fire AFTER step t's commit
    returns, and are recovered before step t+1 dispatches — the window
    where a real SIGBUS lands relative to the commit loop;
  * mid-window faults (mid_window=True) fire INSIDE step t's commit at
    the engine's fault-arrival point (after the in-window commit, before
    any boundary flush), via `Pool.set_arrival_hook`.

Every commit's wall latency (ending in a device synchronise) is recorded
and classified clean vs during-disturbance (within `disturb_steps` of any
event), so the campaign reports tail latency under chaos against the
quiet baseline.  Recoveries are timed under the same load.  A recovery
that raises the syndrome-budget-exhausted error falls back to the
checkpoint tier: restore the last snapshot, re-protect, and
deterministically replay the missed traffic — the scenario still must end
bit-identical to golden.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import utils
from repro_torch.chaos.schedule import FAULT_KINDS, ChaosEvent, FaultSchedule
from repro_torch.chaos.workload import PoolWorkload, sync
from repro_torch.pool import Fault
from repro_torch.runtime import failure


def _ms_summary(hist) -> dict:
    """An obs Histogram as the campaign's record shape (percentiles from
    the registry's fixed buckets, clamped to the observed extrema)."""
    s = hist.summary()
    return {"n": s["n"], "p50_ms": s["p50"], "p99_ms": s["p99"]}


def trees_equal(a, b) -> bool:
    """Two pytrees of tensors equal leaf by leaf, byte for byte."""
    la, lb = utils.tree_leaves(a), utils.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def inject_event(protector, prot, event: ChaosEvent, seed: int):
    """Apply one fault event to a ProtectedState via the seeded
    injectors; returns (prot, FailureEvent)."""
    kw = event.kw
    if event.kind == "rank_loss":
        return failure.seeded_rank_loss(protector, prot, seed,
                                        rank=kw.get("rank"))
    if event.kind == "multi_loss":
        return failure.seeded_multi_rank_loss(
            protector, prot, seed, e=kw.get("e", 2), ranks=kw.get("ranks"))
    if event.kind == "scribble":
        return failure.seeded_scribble(
            protector, prot, seed, n_words=kw.get("n_words", 4),
            rank=kw.get("rank"))
    raise ValueError(f"not a fault kind: {event.kind!r}")


class ScenarioRunner:
    def __init__(self, workload: PoolWorkload, schedule: FaultSchedule, *,
                 disturb_steps: int = 3, straggler_base_s: float = 0.01):
        self.wl = workload
        self.schedule = schedule
        self.disturb_steps = int(disturb_steps)
        # synthetic per-step duration fed to the straggler policy (the
        # dilation vector scales it); synthetic, not wall time, so
        # detection is as deterministic as the schedule
        self.straggler_base_s = float(straggler_base_s)

    # -- injection --------------------------------------------------------------

    def _inject_prot(self, prot, event: ChaosEvent):
        """Apply one fault event to a ProtectedState; (prot, event)."""
        return inject_event(self.wl.pool.protector, prot, event,
                            self.schedule.event_seed(event))

    @staticmethod
    def _combine(events: list) -> Fault:
        """Fold simultaneous fault events into one recovery request.

        A scribble concurrent with a rank loss is the overlap single parity
        cannot untangle (the survivors' XOR runs through the scribbled
        row): name every afflicted rank as a loss and solve through the
        syndrome stack."""
        if len(events) == 1:
            return Fault.from_event(events[0])
        ranks: set = set()
        for ev in events:
            if ev.kind == "rank_loss":
                ranks.add(int(ev.lost_rank))
            elif ev.kind == "multi_loss":
                ranks.update(int(r) for r in ev.lost_ranks)
            elif ev.kind == "scribble":
                ranks.update(int(r) for r, _ in ev.locations)
            else:
                raise ValueError(ev.kind)
        if len(ranks) == 1:
            return Fault.rank_loss(ranks.pop())
        return Fault.multi_loss(*ranks)

    # -- the loop ---------------------------------------------------------------

    def run(self, n_steps: int, *, golden: bool = True) -> dict:
        wl, pool = self.wl, self.wl.pool
        snap = wl.snapshot()
        g0 = pool.protector.group_size
        slowdown = np.ones(g0)
        # every wall sample goes through the pool's registry (which
        # survives rescale), and the record is distilled from it
        reg = pool.metrics
        h_clean = reg.histogram("chaos_commit_ms", phase="clean")
        h_during = reg.histogram("chaos_commit_ms", phase="during")
        h_disturb = reg.histogram("chaos_disturbance_ms")
        recoveries: List[dict] = []
        window_trace: List[tuple] = []
        disturbed = set()
        for e in self.schedule:
            disturbed.update(range(e.step, e.step + self.disturb_steps))

        t = 0
        while t < n_steps:
            evs = self.schedule.events_at(t)
            mid = [e for e in evs if e.mid_window]
            post = [e for e in evs
                    if e.kind in FAULT_KINDS and not e.mid_window]
            for e in evs:
                if e.kind == "rescale":
                    t0 = time.perf_counter()
                    wl.rescale(e.kw["shape"])
                    pool = wl.pool
                    sync(wl.device)
                    ms = (time.perf_counter() - t0) * 1e3
                    h_disturb.observe(ms)
                    recoveries.append({"step": t, "kind": "rescale",
                                       "ms": ms})
                    if pool.protector.group_size != g0:
                        g0 = pool.protector.group_size
                        slowdown = np.ones(g0)
                elif e.kind == "straggler_start":
                    slowdown[int(e.kw.get("rank", 0))] = float(
                        e.kw.get("factor", 6.0))
                elif e.kind == "straggler_stop":
                    slowdown[:] = 1.0
                elif e.kind == "snapshot":
                    snap = wl.snapshot()

            pend: list = []
            if mid:
                def hook(prot, since, at_boundary, _mid=mid, _pend=pend,
                         _pool=pool):
                    out = prot
                    for e in _mid:
                        out, ev = self._inject_prot(out, e)
                        # the hook bypasses pool.inject, so the fault is
                        # noted here to keep the trace linkage
                        _pool.note_event(ev)
                        _pend.append(ev)
                    return out
                pool.set_arrival_hook(hook)
            t0 = time.perf_counter()
            wl.traffic_step()
            dt_ms = (time.perf_counter() - t0) * 1e3
            (h_during if t in disturbed else h_clean).observe(dt_ms)
            if mid:
                pool.set_arrival_hook(None)

            if pool.straggler is not None:
                pool.observe_commit_times(self.straggler_base_s * slowdown)
                window_trace.append(
                    (t, pool.engine.window if pool.engine else 1,
                     len(pool.dropped_replicas)))

            for e in post:
                ev = pool.inject(
                    lambda p, prot, _e=e: self._inject_prot(prot, _e))
                pend.append(ev)
            if pend:
                fault = self._combine(pend)
                t0 = time.perf_counter()
                try:
                    rep = pool.recover(fault)
                    sync(wl.device)
                    ms = (time.perf_counter() - t0) * 1e3
                    h_disturb.observe(ms)
                    rec = {"step": t, "ms": ms}
                    rec.update(rep.to_event())
                    recoveries.append(rec)
                except RuntimeError as err:
                    if "syndrome budget exhausted" not in str(err):
                        raise
                    # checkpoint-tier fallback: restore the snapshot,
                    # re-protect, replay the missed traffic exactly
                    wl.restore(snap)
                    wl.replay_to(t + 1)
                    ms = (time.perf_counter() - t0) * 1e3
                    h_disturb.observe(ms)
                    recoveries.append({
                        "step": t, "kind": "restore_replay", "ms": ms,
                        "error": str(err).splitlines()[0],
                        "replayed": t + 1 - snap["t"]})
            t += 1

        out = {
            "steps": n_steps,
            "events": len(self.schedule),
            "r": pool.redundancy,
            "window": self.wl.config.window,
            "commit_ms": {"clean": _ms_summary(h_clean),
                          "during": _ms_summary(h_during)},
            "recovery_ms": _ms_summary(h_disturb),
            "recoveries": recoveries,
            "stats": pool.stats(),
            "health": pool.health().to_dict(),
        }
        if window_trace:
            out["window_trace"] = {
                "min_window": min(w for _, w, _d in window_trace),
                "max_window": max(w for _, w, _d in window_trace),
                "max_dropped": max(d for _, _w, d in window_trace),
                "final_window": window_trace[-1][1],
                "final_dropped": window_trace[-1][2],
            }
        if golden:
            out["golden_exact"] = trees_equal(wl.final_host(),
                                              wl.golden(n_steps))
        return out


def attach_schedule(host, schedule: FaultSchedule,
                    log: Optional[list] = None) -> list:
    """Ride a FaultSchedule on a live runtime host via its step hook.

    Duck-typed: `host.pool` (a Pool, or None for an unprotected host) and
    `host.add_step_hook(fn)`, where `fn(host, out)` runs after each step.
    Fault events inject into the host's pool and route through
    `Pool.recover` (between-commit timing: inject + recover after the
    step that matches the event index).  `straggler_start` / `_stop`
    dilate `host.replica_slowdown` when the host has one.  Returns the
    log list; each fired event appends {"step", "kind", ...}.
    """
    log = log if log is not None else []
    counter = {"t": 0}

    def hook(h, out) -> None:
        t = counter["t"]
        counter["t"] += 1
        pool = h.pool
        if pool is None:
            return
        for e in schedule.events_at(t):
            if e.kind in FAULT_KINDS:
                ev = pool.inject(
                    lambda p, prot, _e=e: inject_event(
                        p, prot, _e, schedule.event_seed(_e)))
                rep = pool.recover(Fault.from_event(ev))
                rec = {"step": t}
                rec.update(rep.to_event())
                log.append(rec)
            elif e.kind == "straggler_start" and hasattr(
                    h, "replica_slowdown"):
                h.replica_slowdown[int(e.kw.get("rank", 0))] = float(
                    e.kw.get("factor", 6.0))
                log.append({"step": t, "kind": e.kind})
            elif e.kind == "straggler_stop" and hasattr(
                    h, "replica_slowdown"):
                h.replica_slowdown[:] = 1.0
                log.append({"step": t, "kind": e.kind})
            else:
                raise ValueError(
                    f"runtime schedule attachment does not support "
                    f"{e.kind!r} events (use ScenarioRunner)")

    host.add_step_hook(hook)
    return log
