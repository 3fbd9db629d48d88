"""Online recovery orchestration (Pangolin §3.6).

Three entry points, all funneling into the Protector's reconstruction ops:

  * `recover_from_rank_loss` — media-error path: a failure event reports a
    lost rank; the pool freezes, survivors rebuild the row from parity,
    the pool resumes.
  * `recover_from_e_loss`    — e <= r ranks lost at once, rebuilt from the
    syndrome stack through the e x e Vandermonde solve; e > r is refused.
  * `recover_from_scribble`  — corruption path: checksum mismatches (from
    a scrub) identify (rank, page) victims; targeted page reconstruction
    repairs them in place.

Recovery is idempotent (pure reconstruction from surviving rows + the
stack).  Reports name global ranks: on a zone split over processes each
process reports the zone's recovery.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

from repro_torch.core import txn as txn_mod


@dataclasses.dataclass
class RecoveryReport:
    kind: str                    # "rank_loss" | "multi_loss" | "scribble"
    lost_rank: Optional[int]
    pages: list
    verified: bool               # post-repair checksum verification passed
    frozen: bool
    lost_ranks: Optional[list] = None     # multi-loss: every lost rank
    # deferred engine's window-meta bound (None on the synchronous engine)
    window_bound: Optional[dict] = None
    # post-recovery re-verify (Pool.recover): entry k is S_k's verdict
    synd_ok: Optional[list] = None
    # overall post-recovery re-verify verdict; None when skipped
    reverified: Optional[bool] = None
    # faults that arrived while this recovery was in flight
    followups: int = 0
    # wall timings (ms), in the trace's vocabulary
    queue_wait_ms: Optional[float] = None
    solve_ms: Optional[float] = None
    reverify_ms: Optional[float] = None
    total_ms: Optional[float] = None

    def to_event(self) -> dict:
        """Flatten to the trace/record vocabulary: one flat dict usable
        as a span's end fields or a per-recovery record."""
        ev: dict = {"kind": self.kind, "verified": bool(self.verified),
                    "followups": int(self.followups)}
        if self.lost_rank is not None:
            ev["lost_rank"] = int(self.lost_rank)
        if self.lost_ranks:
            ev["lost_ranks"] = [int(r) for r in self.lost_ranks]
        if self.pages:
            ev["pages"] = [tuple(p) for p in self.pages]
        if self.reverified is not None:
            ev["reverified"] = bool(self.reverified)
        if self.window_bound is not None:
            ev["window_bound_verified"] = bool(
                self.window_bound.get("digest_verified"))
        for f in ("queue_wait_ms", "solve_ms", "reverify_ms", "total_ms"):
            v = getattr(self, f)
            if v is not None:
                ev[f] = round(float(v), 3)
        return ev


def recover_from_rank_loss(protector: txn_mod.Protector,
                           prot: txn_mod.ProtectedState, lost_rank: int,
                           freeze: Optional[Callable] = None,
                           resume: Optional[Callable] = None):
    """Rebuild one data-rank's entire state shard from parity, online."""
    if not protector.mode.has_parity:
        raise RuntimeError(
            f"mode {protector.mode.value} has no parity; rank loss is "
            "unrecoverable online (restore from checkpoint instead)")
    if freeze is not None:
        freeze()
    t0 = time.perf_counter()
    prot, ok = protector.recover_rank(prot, lost_rank)
    verified = bool(ok)
    solve_ms = (time.perf_counter() - t0) * 1e3
    if resume is not None:
        resume()
    return prot, RecoveryReport("rank_loss", lost_rank, [], verified,
                                freeze is not None, solve_ms=solve_ms)


def recover_from_e_loss(protector: txn_mod.Protector,
                        prot: txn_mod.ProtectedState,
                        lost_ranks: Sequence[int],
                        freeze: Optional[Callable] = None,
                        resume: Optional[Callable] = None):
    """Rebuild e <= r lost data-ranks' rows from the syndrome stack.

    e = 1 takes the single-parity path.  e > r raises before anything is
    touched: an e x e solve through an r < e stack would return garbage
    rows.
    """
    ranks = sorted(int(a) for a in lost_ranks)
    e = len(ranks)
    protector.check_budget(ranks)
    if freeze is not None:
        freeze()
    t0 = time.perf_counter()
    if e == 1:
        prot, ok = protector.recover_rank(prot, ranks[0])
    else:
        prot, ok = protector.recover_e(prot, ranks)
    verified = bool(ok)
    solve_ms = (time.perf_counter() - t0) * 1e3
    if resume is not None:
        resume()
    if e == 1:
        return prot, RecoveryReport("rank_loss", ranks[0], [], verified,
                                    freeze is not None, solve_ms=solve_ms)
    return prot, RecoveryReport("multi_loss", None, [], verified,
                                freeze is not None, lost_ranks=ranks,
                                solve_ms=solve_ms)


def recover_from_double_loss(protector: txn_mod.Protector,
                             prot: txn_mod.ProtectedState,
                             lost_ranks: Sequence[int],
                             freeze: Optional[Callable] = None,
                             resume: Optional[Callable] = None):
    """The e = 2 erasure recovery."""
    a, b = (int(r) for r in lost_ranks)
    return recover_from_e_loss(protector, prot, (a, b), freeze=freeze,
                               resume=resume)


def recover_from_scribble(protector: txn_mod.Protector,
                          prot: txn_mod.ProtectedState,
                          locations: Sequence[tuple],
                          freeze: Optional[Callable] = None,
                          resume: Optional[Callable] = None):
    """Repair (rank, page) scribble victims from parity, online."""
    if not protector.mode.has_parity:
        raise RuntimeError("scribble repair requires parity")
    if freeze is not None:
        freeze()
    t0 = time.perf_counter()
    ranks = [r for r, _ in locations]
    pages = [p for _, p in locations]
    prot, ok = protector.repair_pages(prot, ranks, pages)
    verified = bool(ok)
    solve_ms = (time.perf_counter() - t0) * 1e3
    if resume is not None:
        resume()
    return prot, RecoveryReport("scribble", None, list(locations), verified,
                                freeze is not None, solve_ms=solve_ms)
