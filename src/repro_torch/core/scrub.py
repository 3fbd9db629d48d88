"""Periodic scrubbing (Pangolin §3.3).

The scrubber walks the whole pool's checksums every `period` transactions
and hands any mismatches to repair.  It freezes the pool while repair runs.
With a deferred engine it also closes the adaptive-window loop: a suspect
scrub or pre-check collapses the window to 1, a clean one regrows it, and
`growth_commits` consecutive clean commits regrow it under load.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.core import txn as txn_mod


@dataclasses.dataclass
class ScrubReport:
    step: int
    checked: bool
    bad_locations: list          # [(rank, page), ...]
    parity_ok: Optional[bool]
    repaired: bool
    repair_ok: Optional[bool]
    row_cache_ok: Optional[bool] = None   # cached row == flatten(state)
    # per-syndrome invariant verdicts, index k = S_k (entry 0 mirrors
    # parity_ok); None when the mode keeps no syndromes
    synd_ok: Optional[list] = None
    # True when this report came from the rank-local pre-check
    local_only: bool = False
    # checksum-mismatch block count from the pre-check's compact verdict;
    # None when the report carries per-block locations instead
    bad_count: Optional[int] = None

    @property
    def suspect(self) -> bool:
        """Any signal that the pool (or its redundancy) is unhealthy."""
        return (bool(self.bad_locations) or bool(self.bad_count)
                or self.parity_ok is False
                or (self.synd_ok is not None and not all(self.synd_ok))
                or self.row_cache_ok is False)


def _u32(step: torch.Tensor) -> int:
    return int(step) & 0xFFFFFFFF


class Scrubber:
    """Transaction-count-based scrubbing with online repair.

    `engine` (a DeferredProtector, or None) receives the scrub pressure:
    any error shrinks its window toward 1, a clean scrub or pre-check lets
    it regrow.  `growth_commits` (> 0) also regrows a shrunken window every
    N consecutive clean commits, at an epoch boundary.
    """

    def __init__(self, protector: txn_mod.Protector, period: int = 0,
                 auto_repair: bool = True, engine=None,
                 growth_commits: int = 0):
        self.protector = protector
        self.period = period          # 0 = disabled
        self.auto_repair = auto_repair
        self.engine = engine          # Optional[epoch.DeferredProtector]
        self.growth_commits = int(growth_commits)   # 0 = scrub-only growth
        self._since = 0
        self._clean_streak = 0
        # telemetry (repro_torch.obs): the Pool assigns its registry here
        self.metrics = None
        # coverage accounting — prechecks and full scrubs both check every
        # rank's blocks against the checksum table; only a full scrub
        # verifies the syndrome stack against the full rows
        self.pool_pages = (protector.layout.n_blocks
                           * protector.group_size)
        self.n_prechecks = 0
        self.n_full_scrubs = 0
        self.pages_checked = 0            # checksum-verified (all kinds)
        self.pages_syndrome_verified = 0  # full-row syndrome coverage
        self.last_suspect: Optional[bool] = None
        # the shared scrub scheduler's hooks (repro_torch.tenancy): commit
        # ages since any verification pass and since a full scrub
        self.commits_since_check = 0
        self.commits_since_full = 0

    def coverage(self) -> dict:
        """Exact verification-coverage record."""
        passes = self.n_prechecks + self.n_full_scrubs
        return {
            "pool_pages": self.pool_pages,
            "prechecks": self.n_prechecks,
            "full_scrubs": self.n_full_scrubs,
            "pages_checked": self.pages_checked,
            "pages_syndrome_verified": self.pages_syndrome_verified,
            "full_fraction": (self.n_full_scrubs / passes
                              if passes else None),
            "syndrome_coverage": (self.pages_syndrome_verified
                                  / self.pages_checked
                                  if self.pages_checked else None),
        }

    def _publish(self, kind: str, report, wall_ms: float) -> None:
        """Fold one scrub pass into the registry (no-op when unwired)."""
        self.last_suspect = report.suspect
        if self.metrics is None:
            return
        reg = self.metrics
        reg.counter("scrub_runs_total", kind=kind).inc()
        if report.suspect:
            reg.counter("scrub_suspect_total", kind=kind).inc()
        reg.histogram("scrub_wall_ms", kind=kind).observe(wall_ms)
        reg.counter("scrub_pages_verified_total",
                    kind=kind).inc(self.pool_pages)
        if report.bad_locations:
            reg.counter("scrub_bad_pages_total").inc(
                len(report.bad_locations))
        if report.bad_count:
            reg.counter("scrub_precheck_bad_blocks_total").inc(
                report.bad_count)
        if report.synd_ok is not None and not all(report.synd_ok):
            reg.counter("scrub_digest_mismatch_total").inc(
                sum(1 for v in report.synd_ok if not v))
        cov = self.coverage()
        if cov["full_fraction"] is not None:
            reg.gauge("scrub_coverage_full_fraction").set(
                cov["full_fraction"])

    def due(self) -> bool:
        if self.period <= 0:
            return False
        return self._since >= self.period

    def on_commit(self, clean: bool = True):
        """Count a commit toward the scrub cadence.  `clean` is the
        host-known verdict: a dirty commit resets the clean streak; a long
        enough streak regrows the window — at an epoch boundary only, so an
        open window never outgrows the cadence it opened under (the streak
        persists across a skipped boundary)."""
        self._since += 1
        self.commits_since_check += 1
        self.commits_since_full += 1
        if not clean:
            self._clean_streak = 0
            return
        self._clean_streak += 1
        eng = self.engine
        if (eng is not None and self.growth_commits > 0
                and self._clean_streak >= self.growth_commits
                and eng.window < eng.max_window and not eng.needs_flush):
            eng.report_pressure(False)        # sustained clean load
            self._clean_streak = 0

    def note_suspect(self):
        """Reset the clean streak (a failure event was handled)."""
        self._clean_streak = 0

    def _feed_engine(self, report) -> None:
        """Adaptive window: errors shrink it toward 1, clean regrows it."""
        if self.engine is not None:
            self.engine.report_pressure(report.suspect)
            if report.suspect:
                self._clean_streak = 0

    def mark_checked(self):
        """Restart the scrub cadence: a check stood in for a full scrub."""
        self._since = 0

    def _host_report(self, prot, out: dict, *, local: bool) -> tuple:
        """Move the scrub outputs to the host; build the report."""
        bad_locations = []
        if "bad_pages" in out:
            # (*mesh_dims, n_blocks) -> (G, n_blocks): a page is bad if
            # any non-data mesh coordinate flags it; a split zone's
            # processes gather their blocks, so each reports the zone's
            # list in global ranks
            bad = out["bad_pages"].movedim(self.protector.data_dim, 0)
            bad = bad.reshape(bad.shape[0], -1, bad.shape[-1]).any(dim=1)
            group = self.protector.group
            if group is not None:
                bad = group.gather_dim(bad, 0)
            ranks, pages = torch.nonzero(bad, as_tuple=True)
            bad_locations = list(zip(ranks.tolist(), pages.tolist()))
        synd_ok = ([bool(v) for v in out["synd_ok"].tolist()]
                   if "synd_ok" in out else None)
        parity_ok = synd_ok[0] if synd_ok else None
        row_cache_ok = (bool(out["row_cache_ok"])
                        if "row_cache_ok" in out else None)
        bad_count = (int(out["bad_count"])
                     if "bad_count" in out else None)
        return bad_locations, ScrubReport(
            _u32(prot.step), True, bad_locations, parity_ok, False,
            None, row_cache_ok=row_cache_ok, synd_ok=synd_ok,
            local_only=local, bad_count=bad_count)

    def precheck(self, prot: txn_mod.ProtectedState) -> ScrubReport:
        """Rank-local scrub (`Protector.local_scrub`): the cheap pre-check
        before a global scrub.  No repair and no cadence reset: a suspect
        pre-check should escalate to `run`."""
        mode = self.protector.mode
        if not (mode.has_cksums or mode.has_parity):
            return ScrubReport(_u32(prot.step), False, [], None, False,
                               None, local_only=True)
        t0 = time.perf_counter()
        _, report = self._host_report(
            prot, self.protector.local_scrub(prot), local=True)
        self.n_prechecks += 1
        self.pages_checked += self.pool_pages
        self.commits_since_check = 0
        self._publish("precheck", report,
                      (time.perf_counter() - t0) * 1e3)
        # a clean pre-check standing in for a scrub regrows the window as a
        # clean scrub would
        self._feed_engine(report)
        return report

    def run(self, prot: txn_mod.ProtectedState,
            freeze: Optional[Callable] = None,
            resume: Optional[Callable] = None):
        """Scrub (and repair) the pool.  Returns (prot, ScrubReport)."""
        self._since = 0
        mode = self.protector.mode
        if not (mode.has_cksums or mode.has_parity):
            return prot, ScrubReport(_u32(prot.step), False, [], None,
                                     False, None)
        if freeze is not None:
            freeze()
        t0 = time.perf_counter()
        bad_locations, report = self._host_report(
            prot, self.protector.scrub(prot), local=False)
        if bad_locations and self.auto_repair and mode.has_parity:
            ranks = [r for r, _ in bad_locations]
            pages = [p for _, p in bad_locations]
            prot, ok = self.protector.repair_pages(prot, ranks, pages)
            report.repaired = True
            report.repair_ok = bool(ok)
            if self.metrics is not None:
                self.metrics.counter("scrub_repairs_total").inc()
                if not report.repair_ok:
                    self.metrics.counter(
                        "scrub_repair_failures_total").inc()
        wall_ms = (time.perf_counter() - t0) * 1e3
        self.n_full_scrubs += 1
        self.pages_checked += self.pool_pages
        self.commits_since_check = 0
        self.commits_since_full = 0
        if mode.has_parity:
            self.pages_syndrome_verified += self.pool_pages
        self._publish("full", report, wall_ms)
        if resume is not None:
            resume()
        self._feed_engine(report)
        return prot, report
