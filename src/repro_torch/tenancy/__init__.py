"""Multi-tenant plane over the Pool facade (the reference's repro.tenancy).

`PoolGroup` hosts many protected pools at once: same-shape, same-config
tenants share one `Cohort` (one Protector) and commit in batched waves —
one launch of each kernel for T tenants instead of T — while a shared
`ScrubScheduler` spreads verification pressure across tenants under a
global page budget, and `QoSClass` presets map tenants onto the protection
ladder.  See group.py for the design notes.
"""
from repro_torch.tenancy.group import (Cohort, PoolGroup, TenantHandle,
                                       cohort_key)
from repro_torch.tenancy.qos import BRONZE, GOLD, PRESETS, SILVER, QoSClass
from repro_torch.tenancy.scheduler import ScrubScheduler

__all__ = [
    "PoolGroup", "TenantHandle", "Cohort", "cohort_key",
    "QoSClass", "GOLD", "SILVER", "BRONZE", "PRESETS",
    "ScrubScheduler",
]
