"""repro_torch — the PyTorch / CUDA port of the Pangolin protection library.

A second package beside the JAX reference `repro`, for one NVIDIA H100:
the same protection engine computing the same bytes, with the reference's
Pallas TPU kernels rewritten by hand for Hopper (kernels/csrc/*.cu).  It
runs the synchronous engine and the deferred-epoch engine
(`ProtectConfig(window=W)`) behind the `Pool` facade, at redundancy
r = 1..4 (XOR parity plus up to three GF(2^32) syndromes):

    from repro_torch import Pool, Fault, ProtectConfig, P, ZoneMesh

    mesh = ZoneMesh((4, 2), ("data", "model"))
    pool = Pool.open(state, specs, mesh=mesh,
                     config=ProtectConfig(mode="mlpc"))   # on the GPU
    with pool.transaction() as tx:
        tx.stage(new_state)
    pool.recover(Fault.rank_loss(2))
    # with ProtectConfig(redundancy=3): pool.recover(Fault.multi_loss(1, 2, 3))
    # with ProtectConfig(window=8): the stack refreshed every 8th commit

`Protector` stays importable as the low-level engine layer.
"""

__version__ = "0.1.0"

from repro_torch.configs.base import ProtectConfig
from repro_torch.core.txn import Mode, ProtectedState, Protector
from repro_torch.dist.sharding import P, ZoneMesh
from repro_torch.obs.health import HealthReport
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.pool import Fault, Pool, Transaction

__all__ = ["Pool", "Fault", "Transaction", "ProtectConfig", "Mode",
           "Protector", "ProtectedState", "P", "ZoneMesh",
           "MetricsRegistry", "Tracer", "HealthReport"]
