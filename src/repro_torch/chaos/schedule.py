"""Seeded, replayable fault timelines.

A schedule is a list of `ChaosEvent`s keyed to commit indices.  Replay
determinism is the load-bearing property: the golden-run comparison only
means something if the same seed produces the same victims at the same
steps on every run, so event randomness (which rank dies, which words
get scribbled) is resolved by the seeded injectors in
runtime/failure.py — the schedule itself carries only *when* and *what
kind*, plus any pinned parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

# fault kinds route to runtime/failure.py injectors + Pool.recover;
# control kinds steer the runner (no state corruption of their own)
FAULT_KINDS = ("rank_loss", "multi_loss", "scribble")
CONTROL_KINDS = ("rescale", "straggler_start", "straggler_stop",
                 "snapshot")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled disturbance.

    step        commit index the event fires at (0-based)
    kind        one of FAULT_KINDS or CONTROL_KINDS
    mid_window  fault kinds only: fire at the engine's in-window
                arrival point (between a commit and its boundary
                flush) instead of between whole commits
    args        kind-specific pins, e.g. {"rank": 2} for rank_loss,
                {"ranks": [0, 3]} or {"e": 2} for multi_loss,
                {"n_words": 4} for scribble, {"shape": (8, 1)} for
                rescale, {"rank": 1, "factor": 6.0} for
                straggler_start.  Anything not pinned is drawn from
                the campaign seed deterministically.
    """
    step: int
    kind: str
    mid_window: bool = False
    args: tuple = ()     # sorted (key, value) pairs — hashable/frozen

    def __post_init__(self):
        if self.kind not in FAULT_KINDS + CONTROL_KINDS:
            raise ValueError(
                f"unknown chaos event kind {self.kind!r}; fault kinds "
                f"are {FAULT_KINDS}, control kinds {CONTROL_KINDS}")
        if self.mid_window and self.kind not in FAULT_KINDS:
            raise ValueError(
                f"mid_window only applies to fault kinds, not "
                f"{self.kind!r}")

    @staticmethod
    def make(step: int, kind: str, mid_window: bool = False,
             **args) -> "ChaosEvent":
        return ChaosEvent(step, kind, mid_window,
                          tuple(sorted(args.items())))

    @property
    def kw(self) -> dict:
        return dict(self.args)


class FaultSchedule:
    """An ordered, seeded timeline of ChaosEvents.

    `seed` salts every unpinned choice the events leave open; two
    schedules with the same events and seed replay identically (the
    injectors key their RNG off (seed, event index, kind)).
    """

    def __init__(self, events: Sequence[ChaosEvent], seed: int = 0):
        self.events: List[ChaosEvent] = sorted(
            events, key=lambda e: (e.step, e.kind))
        self.seed = int(seed)
        self._by_step: Dict[int, List[ChaosEvent]] = {}
        for ev in self.events:
            self._by_step.setdefault(ev.step, []).append(ev)

    def events_at(self, step: int) -> List[ChaosEvent]:
        return self._by_step.get(step, [])

    def event_seed(self, event: ChaosEvent) -> int:
        """The per-event sub-seed: stable under schedule replay."""
        return self.seed * 1_000_003 + self.events.index(event)

    @property
    def last_step(self) -> int:
        return self.events[-1].step if self.events else -1

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)
