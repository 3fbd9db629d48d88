"""`HealthReport` — "what is my integrity health right now?".

The report folds the pool's live degradation signals into one
green / degraded / critical verdict with named reasons, built entirely
from host-known state (straggler drops, adaptive-window pressure, scrub
findings, syndrome budget) — asking for health never touches the device,
so a monitoring loop can poll it at any cadence without perturbing the
commit path.

Status semantics (tests/test_obs.py pins the transitions):

  * critical — the pool cannot currently guarantee its fault contract:
    the syndrome budget was exhausted (an e > r storm hit; online
    recovery refused and the pool is waiting on the checkpoint tier), a
    post-recovery re-verify failed (residual corruption after a
    reconstruction), or a scrub found corruption it could not repair.
  * degraded — protected but impaired: replicas dropped by the
    straggler policy, failure suspicion outstanding (a recovery or
    suspect scrub collapsed the adaptive window and no clean scrub has
    cleared it yet), or the window is pressure-collapsed below its
    ceiling.
  * green — none of the above.

Healing is symmetric: straggler drops clear when the policy re-admits
the replica; suspicion clears on the next clean scrub/pre-check; budget
exhaustion clears when the pool is re-armed (`pool.init` after the
checkpoint-tier restore).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

GREEN, DEGRADED, CRITICAL = "green", "degraded", "critical"


@dataclasses.dataclass
class HealthReport:
    status: str                          # green | degraded | critical
    reasons: List[str]                   # why, one phrase per signal
    # window state
    window: int                          # current adaptive window
    max_window: int                      # configured ceiling
    # degradation signals
    dropped_replicas: List[int]
    suspect: bool                        # failure suspicion outstanding
    # syndrome budget
    redundancy: int                      # configured stack height r
    budget_remaining: int                # 0 after an e > r exhaust
    budget_exhausted: bool
    # scrub findings
    scrub_coverage: Optional[dict]       # Scrubber.coverage() or None
    unrepaired_pages: int                # bad pages the last scrub could
                                         # not repair
    reverify_failed: bool                # last recovery's re-verify
    # recovery history (host counters)
    recoveries: int
    recovery_followups: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def assess(*, window: int, max_window: int, dropped_replicas,
           suspect: bool, redundancy: int, budget_exhausted: bool,
           scrub_coverage: Optional[dict], unrepaired_pages: int,
           reverify_failed: bool, recoveries: int,
           recovery_followups: int) -> HealthReport:
    """Fold the raw signals into a HealthReport (pure function — the
    Pool gathers the inputs, this ranks them)."""
    dropped = sorted(int(r) for r in dropped_replicas)
    reasons: List[str] = []
    status = GREEN
    if dropped:
        status = DEGRADED
        reasons.append(f"straggler policy dropped replicas {dropped}")
    if suspect:
        status = DEGRADED
        reasons.append("failure suspicion outstanding "
                       "(no clean scrub since the last fault)")
    if max_window > 1 and window < max_window:
        status = DEGRADED
        reasons.append(f"adaptive window collapsed ({window} < "
                       f"ceiling {max_window})")
    if unrepaired_pages:
        status = CRITICAL
        reasons.append(f"{unrepaired_pages} corrupted page(s) the last "
                       "scrub could not repair")
    if reverify_failed:
        status = CRITICAL
        reasons.append("post-recovery re-verify failed "
                       "(residual corruption)")
    if budget_exhausted:
        status = CRITICAL
        reasons.append("syndrome budget exhausted (e > r storm; "
                       "restore from the checkpoint tier and re-arm)")
    return HealthReport(
        status=status, reasons=reasons, window=int(window),
        max_window=int(max_window), dropped_replicas=dropped,
        suspect=bool(suspect), redundancy=int(redundancy),
        budget_remaining=0 if budget_exhausted else int(redundancy),
        budget_exhausted=bool(budget_exhausted),
        scrub_coverage=scrub_coverage,
        unrepaired_pages=int(unrepaired_pages),
        reverify_failed=bool(reverify_failed),
        recoveries=int(recoveries),
        recovery_followups=int(recovery_followups))
