"""examples/quickstart.py steps 1-7 through the reference's Pool and the
port's, side by side: open, transaction, rank loss + recover, scribble +
scrub + repair, canary abort, stats / health.  After every step the
protected fields are byte-equal, and the reports agree.  Also the scrub
cadence (`maybe_scrub` with a pre-check every other due scrub)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ProtectConfig as RefConfig
from repro.pool import Fault as RefFault
from repro.pool import Pool as RefPool
from repro.runtime import failure as ref_failure
from repro_torch import Fault, Pool, ProtectConfig
from repro_torch.runtime import failure
from tests._torch_ref import (assert_prot_same, jax_mesh, jax_specs,
                              port_specs, to_jax, to_torch, zone_mesh)
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SPECS = {"w_fsdp": ("data", "model"), "w_tp": (None, "model"), "scale": ()}


def _quickstart_state():
    return {
        "w_fsdp": np.asarray(jnp.arange(16 * 64, dtype=jnp.float32)
                             .reshape(16, 64) * .01),
        "w_tp": np.asarray(jnp.ones((8, 32), jnp.bfloat16)),
        "scale": np.asarray(jnp.float32(1.0)),
    }


def _doubled(state):
    return {k: np.asarray((jnp.asarray(v) * 2).astype(v.dtype))
            for k, v in state.items()}


class Pools:
    def __init__(self, **cfg):
        self.mesh, zmesh = jax_mesh("mesh42"), zone_mesh("mesh42")
        state = _quickstart_state()
        self.ref = RefPool.open(to_jax(state, SPECS, self.mesh),
                                jax_specs(SPECS), mesh=self.mesh,
                                config=RefConfig(**cfg))
        self.port = Pool.open(to_torch(state), port_specs(SPECS), mesh=zmesh,
                              config=ProtectConfig(**cfg), device="cpu")
        self.check()

    def check(self):
        assert_prot_same(self.ref.prot, self.mesh, self.port.prot)
        assert self.ref.step == self.port.step

    def commit(self, state, **kw):
        rok = self.ref.commit(to_jax(state, SPECS, self.mesh), **kw)
        pok = self.port.commit(to_torch(state), **kw)
        assert bool(rok) == bool(pok)
        self.check()


def _report(rep):
    d = dataclasses.asdict(rep)
    for k in ("solve_ms", "reverify_ms", "total_ms", "queue_wait_ms"):
        d.pop(k, None)
    return d


def test_quickstart_steps_1_to_7():
    # 1-2. open: checksums + XOR parity over the 4-rank zone
    pools = Pools(mode="mlpc", block_words=64)
    ref, port, mesh = pools.ref, pools.port, pools.mesh
    assert port.overhead_report() == ref.overhead_report()

    # 3. transactional update
    new_state = _doubled(_quickstart_state())
    key = jax.random.PRNGKey(0)
    with ref.transaction(rng_key=key) as rtx:
        rtx.stage(to_jax(new_state, SPECS, mesh))
    with port.transaction(rng_key=[int(w) for w in jax.random.key_data(key)]
                          ) as ptx:
        ptx.stage(to_torch(new_state))
    assert rtx.ok and ptx.ok and ref.step == port.step == 1
    pools.check()
    want = np.asarray(port.state["w_fsdp"]).copy()
    np.testing.assert_array_equal(want, new_state["w_fsdp"])

    # 4. media error: lose data-rank 2 entirely; rebuild online from parity
    ref.prot, rev = ref_failure.inject_rank_loss(ref.protector, ref.prot, 2)
    port.prot, pev = failure.inject_rank_loss(port.protector, port.prot, 2)
    pools.check()
    rrep = ref.recover(RefFault.rank_loss(rev.lost_rank))
    prep = port.recover(Fault.rank_loss(pev.lost_rank))
    assert prep.verified and _report(prep) == _report(rrep)
    pools.check()
    np.testing.assert_array_equal(np.asarray(port.state["w_fsdp"]), want)

    # 5. silent scribble: flip bits, detect by scrub, repair the page
    ref.prot, _ = ref_failure.inject_scribble(ref.protector, ref.prot,
                                              rank=1, word_offsets=[7])
    port.prot, _ = failure.inject_scribble(port.protector, port.prot,
                                           rank=1, word_offsets=[7])
    pools.check()
    rsr, psr = ref.scrub(), port.scrub()
    assert psr.bad_locations == rsr.bad_locations == [(1, 0)]
    assert psr.repaired and psr.repair_ok
    assert dataclasses.asdict(psr) == dataclasses.asdict(rsr)
    pools.check()
    np.testing.assert_array_equal(np.asarray(port.state["w_fsdp"]), want)

    # 6. canary: a staged buffer overrun aborts the commit, state untouched
    zeros = {k: np.zeros_like(v) for k, v in new_state.items()}
    with ref.transaction() as rtx:
        rtx.watch(ref_failure.smashed_canary_buffer(4096))
        rtx.stage(to_jax(zeros, SPECS, mesh))
    with port.transaction() as ptx:
        ptx.watch(failure.smashed_canary_buffer(4096, device="cpu"))
        ptx.stage(to_torch(zeros))
    assert ptx.aborted and not ptx.ok and rtx.aborted and not rtx.ok
    assert port.step == ref.step == 1
    pools.check()

    # 7. telemetry: stats and health agree, and a clean scrub heals
    rs, ps = ref.stats(), port.stats()
    for k in ("commits", "aborted_commits", "recoveries", "scrub"):
        assert ps[k] == rs[k], k
    assert ps["recoveries"] == 1 and ps["aborted_commits"] == 1
    assert port.health().status == ref.health().status == "degraded"
    assert port.health().reasons == ref.health().reasons
    ref.scrub()
    port.scrub()
    assert port.health().status == ref.health().status == "green"
    from repro_torch.obs import prometheus_text
    assert "pool_commits_total" in prometheus_text(port.metrics)


@pytest.mark.parametrize("mode", ["mlpc", "mlp"])
def test_maybe_scrub_cadence_and_precheck(mode):
    pools = Pools(mode=mode, block_words=64, scrub_period=2,
                  full_scrub_every=2)
    ref, port = pools.ref, pools.port
    state = _quickstart_state()
    reports = []
    for i in range(4):
        state = _doubled(state)
        pools.commit(state, data_cursor=i)
        rr, pr = ref.maybe_scrub(), port.maybe_scrub()
        assert (rr is None) == (pr is None)
        if pr is not None:
            assert dataclasses.asdict(pr) == dataclasses.asdict(rr)
            reports.append(pr)
        pools.check()
    assert [r.local_only for r in reports] == [True, False]
    assert port.scrubber.coverage() == ref.scrubber.coverage()
    assert dataclasses.asdict(port.precheck()) == dataclasses.asdict(
        ref.precheck())


def test_verify_old_transaction_through_the_pool():
    pools = Pools(mode="mlpc", block_words=64)
    state = _doubled(_quickstart_state())
    pools.commit(state, verify_old=True, rng_key=None)
    pools.commit(_doubled(state), verify_old=True, dirty_pages=[0, 1],
                 data_cursor=5)


def test_fault_arriving_during_recovery_is_queued():
    """A fault raised from the freeze callback while a recovery runs is
    queued and drained right after it, counted in `followups`."""
    from repro_torch import ZoneMesh
    from repro_torch.dist.sharding import P
    nested = []

    def on_freeze():
        if not nested:
            nested.append(pool.recover(Fault.rank_loss(1)))

    state = {"w": torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)}
    pool = Pool.open(state, {"w": P("data")},
                     mesh=ZoneMesh((4, 1), ("data", "model")),
                     config=ProtectConfig(block_words=16), device="cpu",
                     on_freeze=on_freeze)
    rep = pool.recover(Fault.rank_loss(2))
    assert nested == [None] and rep.followups == 1 and rep.verified
    assert pool.stats()["recoveries"] == 2
