"""Per-tenant QoS classes (repro_torch.tenancy).

A QoS class is nothing more than a named `ProtectConfig` plus a scrub
weight: the protection ladder (mode / redundancy / window) IS the
quality dial this library already has, so mapping tenants to service
levels means mapping them to configs.  Because `PoolGroup` keys its
cohorts by (state signature x config), tenants of the same class and
shape land in the same cohort and share one compiled commit program —
the QoS class doubles as the batching key.

The presets span the ladder the paper evaluates:

  * GOLD   — synchronous mlpc, r=3: every commit refreshes checksums
    and a 3-row syndrome stack (survives 3 simultaneous rank losses);
    scrub weight 4, so the shared scheduler verifies gold pools ~4x as
    eagerly per committed transaction.
  * SILVER — mlpc, r=2 behind a 4-commit deferred window; weight 2.
  * BRONZE — mlpc, r=1 behind an 8-commit window; weight 1 — the
    cheapest protected tier (single XOR parity, redundancy refresh
    amortized over 8 commits, last in line for scrub pressure).

`QoSClass.configure(**overrides)` derives a variant (e.g. a scrub
cadence or streaming threshold tweak) without leaving the class's tier.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ProtectConfig


@dataclasses.dataclass(frozen=True)
class QoSClass:
    """A named protection tier: the config tenants of this class get,
    plus the weight the shared scrub scheduler gives their pressure."""
    name: str
    config: ProtectConfig
    weight: int = 1

    def __post_init__(self):
        if self.weight < 1:
            raise ValueError(
                f"QoSClass.weight={self.weight} — the scrub scheduler "
                "multiplies commit age by this, so it must be >= 1 "
                "(larger = served sooner)")

    def configure(self, **overrides) -> "QoSClass":
        """Same tier, adjusted config knobs (dataclasses.replace)."""
        return dataclasses.replace(
            self, config=dataclasses.replace(self.config, **overrides))


GOLD = QoSClass("gold", ProtectConfig(mode="mlpc", redundancy=3,
                                      window=1), weight=4)
SILVER = QoSClass("silver", ProtectConfig(mode="mlpc", redundancy=2,
                                          window=4), weight=2)
BRONZE = QoSClass("bronze", ProtectConfig(mode="mlpc", redundancy=1,
                                          window=8), weight=1)

PRESETS = {q.name: q for q in (GOLD, SILVER, BRONZE)}
