"""Shared scrub scheduler: one verification budget across many pools.

A PoolGroup hosts N tenants, but scrub bandwidth is a *shared* resource
— every pass reads a pool's worth of pages.  Running each pool's own
cadence independently lets a chatty tenant starve the others of
verification (or, with a naive global cadence, lets an idle tenant eat
passes the busy ones need).  This scheduler round-robins the pressure:

  * Each tick spends at most `page_budget` pages (0 = unlimited: every
    tenant with pending pressure is served), each tenant at most once
    per tick.  A pass over tenant t costs `scrubber.pool_pages` — the
    exact coverage accounting the Scrubber already keeps.
  * Tenants are served in priority order.  Priority is
    `commits_since_check * weight + ticks_waiting`: commit age scaled
    by the tenant's QoS weight, plus one point per tick spent unserved.
    The additive aging term makes the policy starvation-free by
    construction — an idle bronze tenant's priority still grows every
    tick, so its wait is bounded no matter how hot its neighbors run
    (age * weight alone would let a never-committing tenant wait
    forever).
  * Every `full_every`-th serve of a tenant is a FULL scrub
    (syndrome collectives + repair path); the others are the cheap
    rank-local pre-check.  A suspect pre-check escalates to a full
    scrub immediately (budget permitting) — mirroring
    `Pool.maybe_scrub`'s escalation.  Together with the bounded wait
    this bounds every tenant's *full-scrub age*: at most
    `full_every - 1` prechecks (each within a bounded wait) separate
    consecutive full scrubs, so `commits_since_full` cannot grow
    unboundedly for any registered tenant.

The scheduler reads exactly three things off each pool's Scrubber —
`commits_since_check`, `commits_since_full`, `pool_pages` — and calls
`pool.precheck()` / `pool.scrub()`; it never touches engine internals.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class _Entry:
    pool: object                 # repro_torch.pool.Pool
    weight: int = 1
    ticks_waiting: int = 0       # ticks since last served (aging term)
    serves: int = 0              # lifetime passes served
    quarantined: bool = False    # excluded from scheduling


class ScrubScheduler:
    def __init__(self, *, page_budget: int = 0, full_every: int = 4):
        assert page_budget >= 0, page_budget
        assert full_every >= 1, full_every
        self.page_budget = int(page_budget)
        self.full_every = int(full_every)
        self._tenants: dict = {}          # tid -> _Entry (insertion order)
        self.ticks = 0
        self.pages_spent = 0              # lifetime page cost
        self.passes = 0                   # lifetime serves (all kinds)

    # -- membership --------------------------------------------------------

    def register(self, tid, pool, weight: int = 1) -> None:
        assert tid not in self._tenants, f"tenant {tid!r} already registered"
        assert weight >= 1, weight
        self._tenants[tid] = _Entry(pool=pool, weight=int(weight))

    def unregister(self, tid) -> None:
        self._tenants.pop(tid, None)

    def set_quarantined(self, tid, flag: bool) -> None:
        if tid in self._tenants:
            self._tenants[tid].quarantined = bool(flag)

    # -- introspection -----------------------------------------------------

    def priority(self, tid) -> int:
        e = self._tenants[tid]
        return (e.pool.scrubber.commits_since_check * e.weight
                + e.ticks_waiting)

    def max_check_age(self) -> int:
        """Largest commits-since-any-verification across tenants."""
        return max((e.pool.scrubber.commits_since_check
                    for e in self._tenants.values()), default=0)

    def max_full_age(self) -> int:
        """Largest commits-since-full-scrub across tenants — the bound
        the starvation-freedom argument is about."""
        return max((e.pool.scrubber.commits_since_full
                    for e in self._tenants.values()), default=0)

    def stats(self) -> dict:
        return {"tenants": len(self._tenants), "ticks": self.ticks,
                "passes": self.passes, "pages_spent": self.pages_spent,
                "max_check_age": self.max_check_age(),
                "max_full_age": self.max_full_age()}

    # -- the tick ----------------------------------------------------------

    def tick(self, page_budget: Optional[int] = None) -> list:
        """Serve scrub passes by priority until the page budget is spent.

        Returns [(tid, kind, report)] for the passes run this tick
        (kind in {"precheck", "full"}); an escalated suspect pre-check
        contributes two entries for the same tenant.
        """
        budget = self.page_budget if page_budget is None else int(page_budget)
        self.ticks += 1
        served = []
        spent = 0
        # snapshot the candidate order once; each tenant served <= once
        remaining = [tid for tid, e in self._tenants.items()
                     if not e.quarantined]
        while remaining:
            tid = max(remaining, key=self.priority)
            e = self._tenants[tid]
            cost = e.pool.scrubber.pool_pages
            if budget and spent + cost > budget:
                break
            remaining.remove(tid)
            e.serves += 1
            e.ticks_waiting = 0
            spent += cost
            # full-scrub cadence: the full_every-th serve pays for the
            # global collectives; the rest run the rank-local pre-check
            if e.serves % self.full_every == 0:
                served.append((tid, "full", e.pool.scrub()))
            else:
                report = e.pool.precheck()
                served.append((tid, "precheck", report))
                if report.suspect and (not budget
                                       or spent + cost <= budget):
                    # escalation: a suspect pre-check buys the full
                    # scrub (and its repair path) right away
                    spent += cost
                    served.append((tid, "full", e.pool.scrub()))
        # aging: everyone not served this tick moves up the queue
        served_tids = {tid for tid, _, _ in served}
        for tid, e in self._tenants.items():
            if tid not in served_tids and not e.quarantined:
                e.ticks_waiting += 1
        self.passes += len(served)
        self.pages_spent += spent
        return served
