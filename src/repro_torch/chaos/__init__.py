"""Chaos campaign: scripted fault scenarios under live traffic (the
reference's repro.chaos).

The recovery paths are timed on a quiet pool elsewhere; real incidents
arrive mid-traffic — a rank dies between two commits of an open window, a
scribble lands while a rescale is in flight, losses stack up faster than
the syndrome budget refreshes.  This package scripts those storms
deterministically:

  * `FaultSchedule` / `ChaosEvent` — a seeded, replayable timeline of
    faults and control events keyed to commit indices (schedule.py).
  * `PoolWorkload` — deterministic synthetic traffic over a `Pool`: an
    elementwise f32 step whose trajectory is bit-identical across mesh
    shapes, so every scenario can be diffed against a fault-free golden
    run (workload.py).
  * `ScenarioRunner` — drives the workload while the schedule fires,
    recording per-commit latency (clean vs during a disturbance) and
    recovery-under-load timings; ends with the golden bit-identity check
    (runner.py).
  * `scenarios` — the campaign: rescale under traffic, straggler
    degradation, mid-window scribble + loss, syndrome-budget exhaustion
    and re-arm, multi-tenant interference, faults with commits in
    flight, crash/replay storms over r x W (scenarios.py).
  * `attach_schedule` — the same schedules on a live runtime host through
    its step hook (runner.py).

Every scenario also runs on a zone split over processes (`group=`, the
`ZoneGroup` of a spawned world): each process holds its block of each
workload, a rescale may change the process count (a process outside the
new mesh sits the steps out as a spare and rejoins at the next rescale),
and the golden verdict and the budget fallback are agreed across the
processes.  What stays refused: a `PoolGroup` rescale that changes the
process count, and restoring a split zone's snapshot onto another mesh.

`python -m repro_torch.chaos --smoke` runs one short scenario end to end.
"""
from repro_torch.chaos import scenarios
from repro_torch.chaos.runner import (ScenarioRunner, attach_schedule,
                                      inject_event)
from repro_torch.chaos.schedule import ChaosEvent, FaultSchedule
from repro_torch.chaos.workload import PoolWorkload

__all__ = ["ChaosEvent", "FaultSchedule", "PoolWorkload", "ScenarioRunner",
           "attach_schedule", "inject_event", "scenarios"]
