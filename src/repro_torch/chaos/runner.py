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

On a zone split over processes every process walks the whole schedule,
spares included: a spare (a process outside the current mesh after a
rescale that changed the process count) commits nothing and takes part
only in the exchanges of the world's group: the rescales, the golden
verdict, and a restore of a snapshot taken on another mesh, to which it
may have to send its rows.  Every host decision reads values that are
alike on every process: the schedule, the synthetic straggler times,
the combined faults, and the budget-exhausted error, which `Pool.recover`
raises on every process of the zone or on none; where the snapshot's
mesh is not the current one, the zone's first process sends that
verdict to every process at each fault step, so the spares enter the
restore with the zone.  Records are each process's own (a spare's skip
the steps it sat out, listed in `spare_steps`, but for a restore it
took part in).
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from repro_torch.chaos.schedule import FAULT_KINDS, ChaosEvent, FaultSchedule
from repro_torch.chaos.workload import PoolWorkload, sync
from repro_torch.dist import procs
from repro_torch.pool import Fault
from repro_torch.runtime import failure


def _ms_summary(hist) -> dict:
    """An obs Histogram as the campaign's record shape (percentiles from
    the registry's fixed buckets, clamped to the observed extrema)."""
    s = hist.summary()
    return {"n": s["n"], "p50_ms": s["p50"], "p99_ms": s["p99"]}


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

    def _restore(self, snap: dict, t: int, err: Optional[Exception],
                 t0: Optional[float] = None) -> dict:
        """The checkpoint-tier fallback at step t: restore the snapshot,
        re-protect, replay the missed traffic exactly; its record (with
        the bytes this process sent on a split zone).  `err` is the
        budget-exhausted error (None on a spare that only sends)."""
        wl = self.wl
        root = procs.root_of(wl.mesh.group)
        moved = 0 if root is None else root.stats["moved_bytes"]
        t0 = time.perf_counter() if t0 is None else t0
        wl.restore(snap)
        wl.replay_to(t + 1)
        sync(wl.device)
        ms = (time.perf_counter() - t0) * 1e3
        wl.metrics.histogram("chaos_disturbance_ms").observe(ms)
        rec = {"step": t, "kind": "restore_replay", "ms": ms,
               "replayed": t + 1 - snap["t"]}
        if err is not None:
            rec["error"] = str(err).splitlines()[0]
        if root is not None:
            rec["moved_bytes"] = root.stats["moved_bytes"] - moved
        return rec

    # -- the loop ---------------------------------------------------------------

    def run(self, n_steps: int, *, golden: bool = True) -> dict:
        wl, pool = self.wl, self.wl.pool
        snap = wl.snapshot()
        g0 = wl.mesh.group_size
        slowdown = np.ones(g0)
        # every wall sample goes through the workload's registry (which
        # every pool of it shares, across rescales), and the record is
        # distilled from it
        reg = wl.metrics
        root = procs.root_of(wl.mesh.group)
        spare_steps: List[int] = []
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
                    moved = 0 if root is None else root.stats["moved_bytes"]
                    t0 = time.perf_counter()
                    wl.rescale(e.kw["shape"], e.kw.get("procs"))
                    pool = wl.pool
                    sync(wl.device)
                    ms = (time.perf_counter() - t0) * 1e3
                    h_disturb.observe(ms)
                    rec = {"step": t, "kind": "rescale", "ms": ms}
                    if root is not None:      # the rows this process sent
                        rec["moved_bytes"] = (root.stats["moved_bytes"]
                                              - moved)
                    recoveries.append(rec)
                    if wl.mesh.group_size != g0:
                        g0 = wl.mesh.group_size
                        slowdown = np.ones(g0)
                elif e.kind == "straggler_start":
                    slowdown[int(e.kw.get("rank", 0))] = float(
                        e.kw.get("factor", 6.0))
                elif e.kind == "straggler_stop":
                    slowdown[:] = 1.0
                elif e.kind == "snapshot":
                    snap = wl.snapshot()

            # a restore from another mesh is collective over the world:
            # the zone's verdict goes to every process, spares included
            shared = (root is not None and bool(mid or post)
                      and snap["mesh"] is not wl.mesh)
            if pool is None:
                # a spare: no block, so no traffic and no fault lands here
                wl.traffic_step()
                spare_steps.append(t)
                if shared and root.broadcast_host(None, wl.mesh.members[0]):
                    recoveries.append(self._restore(snap, t, None))
                t += 1
                continue
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
            exhausted = None
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
                    exhausted = err
            if shared:
                root.broadcast_host(exhausted is not None,
                                    wl.mesh.members[0])
            if exhausted is not None:
                recoveries.append(self._restore(snap, t, exhausted, t0))
            t += 1

        out = {
            "steps": n_steps,
            "events": len(self.schedule),
            "r": (pool.redundancy if pool is not None
                  else self.wl.config.resolved_redundancy),
            "window": self.wl.config.window,
            "commit_ms": {"clean": _ms_summary(h_clean),
                          "during": _ms_summary(h_during)},
            "recovery_ms": _ms_summary(h_disturb),
            "recoveries": recoveries,
            "stats": pool.stats() if pool is not None else None,
            "health": (pool.health().to_dict() if pool is not None
                       else None),
        }
        if root is not None:
            out["spare_steps"] = spare_steps
        if window_trace:
            out["window_trace"] = {
                "min_window": min(w for _, w, _d in window_trace),
                "max_window": max(w for _, w, _d in window_trace),
                "max_dropped": max(d for _, _w, d in window_trace),
                "final_window": window_trace[-1][1],
                "final_dropped": window_trace[-1][2],
            }
        if golden:
            out["golden_exact"] = wl.golden_exact(n_steps)
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
