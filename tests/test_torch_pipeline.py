"""The async commit ring (core/pipeline.py, `Pool.commit_async`) against
the reference's, on the same numpy states: tickets and the ring with
stand-in verdicts; a pipeline drained at the boundary across {sync,
deferred} x r in {1, 3} x depth in {1, 2, 4, 8}; staged canary aborts
mid-ring on both engines; a recovery with three tickets in flight; the
transaction's device canary; `stage_verdict`.  Every protected field, the
redo log included, is byte-equal to the reference's after the drain."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ProtectConfig as RefConfig
from repro.kernels import ops as ref_ops
from repro.pool import Fault as RefFault
from repro.pool import Pool as RefPool
from repro.runtime import failure as ref_failure
from repro_torch import Fault, Pool, ProtectConfig
from repro_torch.core.pipeline import CommitRing, CommitTicket
from repro_torch.kernels import ops
from repro_torch.obs.trace import Tracer
from repro_torch.runtime import failure
from tests._torch_ref import (assert_prot_same, jax_mesh, jax_specs,
                              key_words, port_specs, small_state_np,
                              state_like, to_jax, to_torch, zone_mesh)
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

MESH = "mesh42"


@functools.lru_cache(maxsize=None)
def _setup():
    state, specs = small_state_np()
    return jax_mesh(MESH), zone_mesh(MESH), state, specs


def _chain(n, seed=0):
    """n successive global states (numpy), each from a seeded rng."""
    _, _, state, _ = _setup()
    return [state_like(100 * seed + i, state) for i in range(n)]


class PipePools:
    """A reference and a port Pool on the same state and config (the
    reference's without donation), fed the same commits."""

    def __init__(self, ref_protector=None, **cfg):
        self.mesh, zmesh, state, self.specs = _setup()
        kw = {} if ref_protector is None else {"protector": ref_protector}
        self.ref = RefPool.open(to_jax(state, self.specs, self.mesh),
                                jax_specs(self.specs), mesh=self.mesh,
                                config=RefConfig(**cfg), donate=False, **kw)
        self.port = Pool.open(to_torch(state), port_specs(self.specs),
                              mesh=zmesh, config=ProtectConfig(**cfg),
                              device="cpu")

    def jax(self, st):
        return to_jax(st, self.specs, self.mesh)

    def check(self):
        assert_prot_same(self.ref.prot, self.mesh, self.port.prot)
        rs, ps = self.ref.stats(), self.port.stats()
        for k in ("commits", "aborted_commits", "in_flight",
                  "pipeline_depth", "window", "scrub"):
            assert ps[k] == rs[k], k


# -- tickets and the ring, with stand-in verdicts ------------------------------


class _FakeScalar:
    """A verdict stand-in with controllable readiness."""

    def __init__(self, value, ready=False):
        self.value = bool(value)
        self._ready = bool(ready)

    def is_ready(self):
        return self._ready

    def __bool__(self):
        return self.value


def test_ticket_resolves_once_and_fires_callback():
    fired = []
    t = CommitTicket(0, torch.tensor(True), on_resolve=fired.append)
    assert not t.resolved and t.ready() and t.event is None   # CPU: ready
    assert t.result() is True
    assert t.resolved and t.resolve_latency_ms is not None
    assert fired == [t] and fired[0].result() is True
    t.result()                                   # idempotent: fires once
    assert fired == [t]
    assert CommitTicket(1, False).result() is False          # host bool


def test_ticket_void_skips_the_device_and_sticks():
    t = CommitTicket(0, _FakeScalar(True, ready=False))
    assert not t.ready() and t.result(block=False) is None
    assert t.void(False) is False and t.voided and t.result() is False


def test_ring_polls_out_of_dispatch_order():
    ring = CommitRing(4)
    slow = _FakeScalar(True, ready=False)
    fast = _FakeScalar(True, ready=True)
    t0 = ring.submit(CommitTicket(0, slow))
    t1 = ring.submit(CommitTicket(1, fast))
    t2 = ring.submit(CommitTicket(2, fast))
    assert ring.poll() == [t1, t2] and not t0.resolved and len(ring) == 1
    slow._ready = True
    assert ring.poll() == [t0] and len(ring) == 0


def test_landed_tickets_poll_in_dispatch_order():
    """A ticket whose commit was waited for at dispatch (a split zone's)
    has landed: ready with no event, whatever its verdict object says, so
    every process's poll resolves the same tickets."""
    ring = CommitRing(4)
    slow = _FakeScalar(False, ready=False)
    t0 = ring.submit(CommitTicket(0, slow, landed=True, staged=True))
    t1 = ring.submit(CommitTicket(1, _FakeScalar(True, ready=False)))
    assert t0.landed and t0.event is None and t0.ready()
    assert ring.poll() == [t0] and t0.result() is False
    assert not t1.ready() and len(ring) == 1


def test_ring_backpressure_drain_and_void_all():
    depths = []
    ring = CommitRing(2, on_depth=depths.append)
    t0 = ring.submit(CommitTicket(0, True))
    t1 = ring.submit(CommitTicket(1, True))
    t2 = ring.submit(CommitTicket(2, True))      # full: t0 force-resolved
    assert t0.resolved and not t1.resolved and not t2.resolved
    assert ring.in_flight == [t1, t2]
    assert ring.drain() == [t1, t2]              # dispatch order
    assert depths == [1, 2, 2, 0]
    bad = CommitRing(3)
    for s in range(3):
        bad.submit(CommitTicket(s, True))
    voided = bad.void_all(False)
    assert len(voided) == 3 and all(t.voided for t in voided)
    assert all(t.result() is False for t in voided)


def test_pipeline_depth_validation():
    with pytest.raises(ValueError):
        ProtectConfig(pipeline_depth=0)
    with pytest.raises(ValueError):
        CommitRing(0)


@pytest.mark.parametrize("checks", [
    [], [True], [False], [True, False], [np.True_, True, True]])
def test_stage_verdict_matches_the_reference(checks):
    """Host bools (a quarantined tenant's False) mixed with device bools
    fold to one 0-d bool, as the reference's; an empty list is True."""
    want = bool(ref_ops.stage_verdict([jnp.asarray(c) for c in checks]))
    mixed = [torch.tensor(bool(c)) if i % 2 else bool(c)
             for i, c in enumerate(checks)]
    for got in (ops.stage_verdict(mixed, device="cpu"),
                ops.stage_verdict([bool(c) for c in checks], device="cpu")):
        assert got.shape == () and got.dtype == torch.bool
        assert bool(got) is want


# -- a drained pipeline == the reference's, engines x r x depth -----------------


@functools.lru_cache(maxsize=None)
def _ref_protector(window, red):
    return PipePools(mode="mlpc", redundancy=red, window=window,
                     block_words=64).ref.protector


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("window", [1, 4], ids=["sync", "deferred"])
@pytest.mark.parametrize("red", [1, 3])
def test_drained_pipeline_bit_identical(window, red, depth):
    """The same chain through both pools' rings at `depth` (the reference
    sharing one Protector across depths); at most `depth` in flight; after
    the drain and the flush every field is byte-equal."""
    pools = PipePools(_ref_protector(window, red), mode="mlpc",
                      redundancy=red, window=window, block_words=64,
                      pipeline_depth=depth)
    chain = _chain(2 * max(window, 2), seed=red)
    rt, pt = [], []
    for i, st in enumerate(chain):
        key, words = key_words(i)
        rt.append(pools.ref.commit_async(pools.jax(st), data_cursor=i,
                                         rng_key=key))
        pt.append(pools.port.commit_async(to_torch(st), data_cursor=i,
                                          rng_key=words))
        assert pools.port.in_flight == pools.ref.in_flight <= depth
    assert pools.port.metrics.gauge("pool_inflight_depth").value == \
        pools.port.in_flight
    pools.port.drain()
    pools.ref.drain()
    assert pools.port.in_flight == 0
    assert [t.result() for t in pt] == [t.result() for t in rt]
    assert all(t.resolved and t.result() for t in pt)
    pools.port.flush()
    pools.ref.flush()
    pools.check()


# -- staged device canaries: aborts inside the ring ------------------------------


@pytest.mark.parametrize("window", [1, 4], ids=["sync", "deferred"])
def test_staged_abort_mid_ring_bit_identical(window):
    """A device canary the host cannot know at dispatch ([T, T, F, T, T]
    through `stage_verdict`) aborts commit 2 inside the ring as the
    reference's does: byte-equal after the drain, the redo log included
    (the staged sync abort appends no record), with the abort counted at
    resolution."""
    pools = PipePools(mode="mlpc", redundancy=2, window=window,
                      block_words=64, pipeline_depth=4)
    verdicts = [True, True, False, True, True]
    tickets = []
    for i, st in enumerate(_chain(5, seed=7)):
        rt = pools.ref.commit_async(
            pools.jax(st), data_cursor=i,
            canary_ok=ref_ops.stage_verdict([jnp.asarray(verdicts[i])]))
        pt = pools.port.commit_async(
            to_torch(st), data_cursor=i,
            canary_ok=ops.stage_verdict([torch.tensor(verdicts[i])]))
        assert pt.staged and rt.staged
        tickets.append(pt)
    assert pools.port.stats()["aborted_commits"] == 0   # not yet resolved
    pools.port.drain()
    pools.ref.drain()
    assert [t.result() for t in tickets] == verdicts
    assert pools.port.stats()["aborted_commits"] == 1
    pools.check()
    pools.port.flush()
    pools.ref.flush()
    pools.check()


def test_staged_sync_abort_keeps_the_log_a_host_abort_appends():
    """The two abort paths of the synchronous engine differ in the redo
    log only: a host-known abort (`canary_ok=False`) appends its record
    unmarked, the staged one selects the whole old state.  Everything else
    is the same."""
    cfg = dict(mode="mlpc", redundancy=3, block_words=64, pipeline_depth=2)
    staged, host = PipePools(**cfg), PipePools(**cfg)
    st = _chain(1, seed=3)[0]
    staged.port.commit_async(to_torch(st), data_cursor=5,
                             canary_ok=torch.tensor(False))
    host.port.commit_async(to_torch(st), data_cursor=5, canary_ok=False)
    staged.port.drain()
    host.port.drain()
    a, b = staged.port.prot, host.port.prot
    for f in ("synd", "cksums", "digest", "row", "step"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.log.mark, b.log.mark)
    assert not torch.equal(a.log.data_cursor, b.log.data_cursor)
    assert int(b.log.data_cursor[1]) == 5 and int(a.log.data_cursor[1]) == 0


def test_transaction_canary_device_stages_the_abort():
    """A smashed guard page, staged through `tx.canary_device()`, aborts
    the async commit as the reference's does."""
    pools = PipePools(mode="mlpc", redundancy=3, block_words=64,
                      pipeline_depth=4)
    st = _chain(1, seed=5)[0]
    rtx = pools.ref.transaction()
    rtx.watch(ref_failure.smashed_canary_buffer(256))
    ptx = pools.port.transaction()
    ptx.watch(failure.smashed_canary_buffer(256, device="cpu"))
    canary = ptx.canary_device()
    assert canary.shape == () and not bool(canary)
    assert bool(rtx.canary_device()) is False
    pools.ref.commit_async(pools.jax(st), canary_ok=rtx.canary_device())
    t = pools.port.commit_async(to_torch(st), canary_ok=canary)
    assert t.result() is False
    pools.ref.drain()
    pools.port.drain()
    pools.check()
    ok = pools.port.transaction().canary_device()   # no guards: clean
    assert bool(ok) and ok.shape == ()


# -- a fault with commits in flight --------------------------------------------


def test_recover_with_three_tickets_in_flight():
    """Recovery drains the ring first: with three unresolved tickets at the
    loss of rank 1, `recover` resolves them, rebuilds, and both pools are
    byte-equal (deferred engine, r = 2, depth 4)."""
    pools = PipePools(mode="mlpc", redundancy=2, window=4, block_words=64,
                      pipeline_depth=4)
    chain = _chain(6, seed=11)
    for i, st in enumerate(chain[:3]):
        pools.ref.commit_async(pools.jax(st), data_cursor=i)
        pools.port.commit_async(to_torch(st), data_cursor=i)
    pools.ref.drain()
    pools.port.drain()
    burst = []
    for i, st in enumerate(chain[3:]):
        pools.ref.commit_async(pools.jax(st), data_cursor=3 + i)
        burst.append(pools.port.commit_async(to_torch(st),
                                             data_cursor=3 + i))
    assert pools.port.in_flight == 3 == pools.port.stats()["in_flight"]
    assert pools.port.metrics.gauge("pool_inflight_depth").value == 3
    pools.ref.inject(lambda p, pr: ref_failure.inject_rank_loss(p, pr, 1))
    prot, _ = failure.inject_rank_loss(pools.port.protector,
                                       pools.port.prot, 1)
    pools.port._est = dataclasses.replace(pools.port._est, prot=prot)
    rrep = pools.ref.recover(RefFault.rank_loss(1))
    prep = pools.port.recover(Fault.rank_loss(1))
    assert prep.verified and rrep.verified and prep.reverified
    assert pools.port.in_flight == 0
    assert all(t.resolved and t.result() for t in burst)
    pools.check()


def test_init_voids_in_flight_tickets_and_set_tracer_swaps_the_sink():
    pools = PipePools(mode="mlpc", block_words=64, pipeline_depth=4)
    sink = Tracer()
    pools.port.set_tracer(sink)
    st = _chain(1, seed=13)[0]
    t = pools.port.commit_async(to_torch(st), data_cursor=1)
    assert any(e["kind"] == "commit_dispatch" for e in sink.events)
    pools.port.init(to_torch(st))
    assert t.voided and t.result() is False and pools.port.in_flight == 0
    t2 = pools.port.commit_async(to_torch(st), data_cursor=2)
    pools.port.drain()
    hist = pools.port.metrics.histogram("pool_commit_resolve_ms")
    assert hist.count == 2
    assert any(e is not None and e[0] == t2.span_id for e in hist.exemplars)
