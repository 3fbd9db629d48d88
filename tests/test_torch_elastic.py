"""Elastic rescale and straggler mitigation (repro_torch.dist.elastic,
repro_torch.dist.straggler, `Pool.rescale`, `PoolGroup.rescale`, the cold
`PoolGroup.admit`, `Pool.observe_commit_times`) against the reference's, on
the same numpy states and the reference's Auto meshes: `reshard_state`
across (4, 2), (8, 1) and (2, 2, 2); `Pool.rescale` at r {1, 2, 3} x window
{1, 4} with a commit pending in the window, byte-equal in every protected
field, the state, the redo log and the step; metrics, tracer and a callable
`dirty_leaf_idx` across a rescale; the group's rescale and cold admission;
the straggler policy's masks on seeded duration sequences (ties, the drop
budget); the window collapsing under a straggler and regrowing, with the
reference's counters."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ProtectConfig as RefConfig
from repro.dist import elastic as ref_elastic
from repro.dist.straggler import StragglerPolicy as RefPolicy
from repro.pool import Pool as RefPool
from repro.tenancy import PoolGroup as RefGroup
from repro_torch import Pool, ProtectConfig, Tracer, convert, utils
from repro_torch.dist import elastic, sharding
from repro_torch.dist.straggler import StragglerPolicy
from repro_torch.tenancy import PoolGroup, cohort_key
from tests._torch_ref import (assert_prot_same, epoch_fields, jax_mesh,
                              jax_specs, key_words, port_specs,
                              small_state_np, stacked, state_like, to_jax,
                              to_torch, zone_mesh)
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

MESH_PAIRS = [(a, b) for a in ("mesh42", "mesh81", "mesh_pod")
              for b in ("mesh42", "mesh81", "mesh_pod") if a != b]


@pytest.mark.parametrize("src,dst", MESH_PAIRS)
def test_reshard_state_is_bit_exact(src, dst):
    """The port's on-device reshard equals the reference's trip through
    the host, shard for shard, and a round trip gives the state back."""
    state, specs = small_state_np()
    want = ref_elastic.reshard_state(to_jax(state, specs, jax_mesh(src)),
                                     jax_mesh(dst), jax_specs(specs))
    ps = port_specs(specs)
    zone = {k: sharding.shard(v, ps[k], zone_mesh(src))
            for k, v in to_torch(state).items()}
    got = elastic.reshard_state(zone, ps, zone_mesh(src), zone_mesh(dst))
    for k in state:
        a = np.asarray(stacked(want[k], jax_mesh(dst)))
        b = got[k]
        b = (b.view(torch.int16) if b.dtype == torch.bfloat16 else b).numpy()
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), k
    back = elastic.reshard_state(got, ps, zone_mesh(dst), zone_mesh(src))
    for k in zone:
        assert torch.equal(back[k], zone[k]), k


class Pair:
    """A reference and a port Pool over `small_state_np` on `mesh`."""

    def __init__(self, mesh="mesh42", pool_kw=None, **cfg):
        self.name = mesh
        self.mesh = jax_mesh(mesh)
        self.cur, self.specs = small_state_np()
        self.ref = RefPool.open(to_jax(self.cur, self.specs, self.mesh),
                                jax_specs(self.specs), mesh=self.mesh,
                                config=RefConfig(block_words=64, **cfg),
                                donate=False, **(pool_kw or {}))
        self.port = Pool.open(to_torch(self.cur), port_specs(self.specs),
                              mesh=zone_mesh(mesh), device="cpu",
                              config=ProtectConfig(block_words=64, **cfg),
                              **(pool_kw or {}))
        self.check()

    def check(self):
        assert_prot_same(self.ref.prot, self.mesh, self.port.prot)
        assert self.ref.step == self.port.step
        if self.ref.engine is not None:
            want = epoch_fields(self.ref._est, self.mesh)
            got = convert.from_port_epoch(self.port._est)
            for k in ("pending", "acc"):
                assert (want[k] is None) == (got[k] is None), k
                assert want[k] is None or \
                    np.asarray(want[k]).tobytes() == got[k].tobytes(), k
            assert self.ref.engine._since == self.port.engine._since
            assert self.ref.engine.window == self.port.engine.window

    def commit(self, seed):
        new = state_like(seed, self.cur)
        key, words = key_words(seed)
        rok = self.ref.commit(to_jax(new, self.specs, self.mesh),
                              rng_key=key, data_cursor=seed)
        pok = self.port.commit(to_torch(new), rng_key=words,
                               data_cursor=seed)
        assert bool(rok) and bool(pok)
        self.cur = new
        self.check()

    def rescale(self, mesh):
        self.name, self.mesh = mesh, jax_mesh(mesh)
        self.ref = self.ref.rescale(self.mesh)
        self.port = self.port.rescale(zone_mesh(mesh))
        self.check()
        for k, v in to_torch(self.cur).items():
            assert torch.equal(self.port.state[k], v), k


@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("red", [1, 2, 3])
def test_pool_rescale_matches_the_reference(red, window):
    """(4, 2) -> (8, 1) -> (4, 2) with a commit pending in the window each
    time: the flush lands it, the stack is rebuilt at the new G (a fresh
    pool on the new mesh holds the same bytes) and the step carries."""
    pair = Pair(mode="mlpc", redundancy=red, window=window)
    pair.commit(1)
    if window > 1:
        assert pair.port.engine.needs_flush
    pair.rescale("mesh81")
    assert pair.port.step == 1 and pair.port.protector.group_size == 8
    fresh = Pool.open(to_torch(pair.cur), port_specs(pair.specs),
                      mesh=zone_mesh("mesh81"), device="cpu",
                      config=pair.port.config)
    for f in ("row", "synd", "cksums", "digest"):
        assert torch.equal(getattr(pair.port.prot, f),
                           getattr(fresh.prot, f)), f
    pair.commit(2)
    pair.rescale("mesh42")
    pair.commit(3)
    assert pair.port.step == 3


def test_rescale_keeps_metrics_tracer_and_reresolves_dirty_leaf_idx():
    """A patch-engine pool whose `dirty_leaf_idx` is a callable of the
    layout: the callable is resolved again against the new layout; the
    new pool publishes into the old pool's registry and into the tracer
    set after it was built, as the reference's does."""
    seen = []

    def leaves(lo):
        seen.append(lo.group_size)
        return [0]
    pair = Pair(mode="mlpc", window=4, pool_kw={"dirty_leaf_idx": leaves})
    tracer = Tracer()
    pair.port.set_tracer(tracer)
    reg = pair.port.metrics
    pair.commit(1)
    pair.rescale("mesh81")
    assert seen == [4, 4, 8, 8]            # the reference's, then the port's
    assert pair.port.engine.patch and pair.port.metrics is reg
    assert pair.port.tracer is tracer
    for name in ("pool_rescales_total", "pool_commits_total"):
        assert reg.counter(name).value == \
            pair.ref.metrics.counter(name).value == 1, name
    spans = [e for e in tracer.events if e["kind"] == "rescale"]
    assert [e["ev"] for e in spans] == ["begin", "end"]
    assert tuple(spans[1]["groups"]) == (4, 8)
    pair.commit(2)


def test_poolgroup_rescale_and_cold_admit_match_the_reference():
    mesh, zmesh = jax_mesh("mesh42"), zone_mesh("mesh42")
    cur, specs = small_state_np()
    cfg = dict(mode="mlpc", redundancy=2, block_words=64)
    ref = RefGroup(mesh)
    port = PoolGroup(zmesh, device="cpu")
    states = {f"t{t}": state_like(100 + t, cur) for t in range(2)}
    for tid, st in states.items():
        ref.admit(tid, to_jax(st, specs, mesh), jax_specs(specs),
                  config=RefConfig(**cfg))
        port.admit(tid, to_torch(st), port_specs(specs),
                   config=ProtectConfig(**cfg))
    # a cold tenant: a pool built, not initialised, in the same cohort
    ref.admit("cold", jax.eval_shape(lambda: to_jax(cur, specs, mesh)),
              jax_specs(specs), config=RefConfig(**cfg))
    cold = port.admit("cold", utils.abstract(to_torch(cur)),
                      port_specs(specs), config=ProtectConfig(**cfg))
    assert cold.pool.prot is None and len(port.cohorts) == 1
    assert cohort_key(utils.abstract(to_torch(cur)), port_specs(specs),
                      ProtectConfig(**cfg)) == \
        cohort_key(to_torch(cur), port_specs(specs), ProtectConfig(**cfg))
    ref["cold"].pool.init(to_jax(cur, specs, mesh))
    cold.pool.init(to_torch(cur))
    states["cold"] = cur
    new_ref = ref.rescale(jax_mesh("mesh81"))
    new_port = port.rescale(zone_mesh("mesh81"))
    assert new_port.tenants == new_ref.tenants == ("t0", "t1", "cold")
    assert new_port.metrics is port.metrics and new_port.tracer is \
        port.tracer
    for tid, st in states.items():
        pool = new_port[tid].pool
        assert pool.protector.group_size == 8
        assert_prot_same(new_ref[tid].pool.prot, jax_mesh("mesh81"),
                         pool.prot)
        for k, v in to_torch(st).items():
            assert torch.equal(pool.state[k], v), (tid, k)
    wave = {tid: state_like(200 + i, cur) for i, tid in enumerate(states)}
    rok = new_ref.commit({tid: to_jax(st, specs, jax_mesh("mesh81"))
                          for tid, st in wave.items()})
    pok = new_port.commit({tid: to_torch(st) for tid, st in wave.items()})
    for tid in wave:
        assert bool(rok[tid]) and bool(pok[tid])
        assert_prot_same(new_ref[tid].pool.prot, jax_mesh("mesh81"),
                         new_port[tid].pool.prot)


POLICIES = [
    # (n replicas, threshold, max_drop_fraction, window)
    (4, 2.0, 0.25, 4), (8, 1.5, 0.25, 3), (100, 2.0, 0.25, 32),
    (100, 1.2, 0.05, 2), (5, 2.0, 0.0, 4), (16, 3.0, 0.5, 1)]


@pytest.mark.parametrize("n,threshold,frac,window", POLICIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_straggler_policy_masks_match_the_reference(n, threshold, frac,
                                                    window, seed):
    """The same masks from seeded duration sequences: slow ranks above the
    threshold times the median, ties between equally slow ranks broken by
    rank, never more drops than the budget, unobserved ranks kept."""
    rng = np.random.default_rng(seed)
    ref = RefPolicy(n, threshold=threshold, max_drop_fraction=frac,
                    window=window)
    port = StragglerPolicy(n, threshold=threshold, max_drop_fraction=frac,
                           window=window)
    assert np.array_equal(port.replica_mask(), ref.replica_mask())
    slow = rng.choice(n, size=max(1, n // 3), replace=False)
    for step in range(12):
        d = rng.uniform(0.009, 0.011, n).round(4)
        if step % 4 != 3:
            # equal slow durations: ties resolve by rank
            d[slow] = rng.choice([0.05, 0.08]) if step % 2 else 0.08
        ranks = range(n) if step else range(n // 2)   # some unobserved
        for r in ranks:
            ref.observe(r, d[r])
            port.observe(r, d[r])
        assert np.array_equal(port.replica_mask(), ref.replica_mask()), step
        assert np.array_equal(port.loss_mask(3 * n + 1),
                              ref.loss_mask(3 * n + 1)), step


def test_observe_commit_times_collapses_and_regrows_like_the_reference():
    pair = Pair(mode="mlpc", window=8, straggler_threshold=2.0,
                window_growth_commits=2)
    pair.ref.straggler = RefPolicy(4, threshold=2.0, window=2)
    pair.port.straggler = StragglerPolicy(4, threshold=2.0, window=2)
    assert pair.port.engine.window == 8

    def observe(d):
        rm = pair.ref.observe_commit_times(d)
        pm = pair.port.observe_commit_times(d)
        assert np.array_equal(rm, pm)
        assert pair.port.dropped_replicas == pair.ref.dropped_replicas
        rh, ph = pair.ref.health(), pair.port.health()
        assert (ph.status, ph.reasons, ph.dropped_replicas) == \
            (rh.status, rh.reasons, rh.dropped_replicas)
        assert pair.port.stats()["dropped_replicas"] == \
            pair.ref.stats()["dropped_replicas"]
        pair.check()
    slow = np.asarray([0.01, 0.08, 0.01, 0.01])
    for i in range(2):
        pair.commit(10 + i)
        observe(slow)
    assert pair.port.dropped_replicas == [1]
    assert pair.port.engine.window == 1
    assert pair.port.health().status == "degraded"
    for _ in range(2):                     # slide the slow samples out
        observe(np.full(4, 0.01))
    assert pair.port.dropped_replicas == []
    for i in range(8):                     # clean commits regrow
        pair.commit(20 + i)
    assert pair.port.engine.window > 1
    for name in ("pool_straggler_drop_total", "pool_straggler_heal_total"):
        assert pair.port.metrics.counter(name).value == \
            pair.ref.metrics.counter(name).value == 1, name
    assert pair.port.metrics.gauge("pool_dropped_replicas").value == 0
    with pytest.raises(RuntimeError, match="no straggler policy"):
        Pool.open(to_torch(pair.cur), port_specs(pair.specs),
                  mesh=zone_mesh("mesh42"),
                  device="cpu").observe_commit_times([0.01] * 4)


def test_rescale_windowed_matches_the_reference():
    """The engine form: flush the pending window, then reshard and rebuild
    on the new mesh with a Protector `make_protector` builds."""
    from repro.core.txn import Mode as RefMode
    from repro.core.txn import Protector as RefProtector
    from repro_torch.core.txn import Mode, Protector
    from tests._torch_ref import EpochPair
    pair = EpochPair("mesh42", "mlpc", window=4, redundancy=2)
    pair.commit(state_like(5, pair.cur), seed=5)
    assert pair.port.needs_flush
    specs = pair.pair.specs
    abstract = jax.eval_shape(lambda: to_jax(pair.cur, specs,
                                             jax_mesh("mesh42")))
    _, rprot = ref_elastic.rescale_windowed(
        pair.ref, pair.rest,
        lambda m: RefProtector(m, abstract, jax_specs(specs),
                               mode=RefMode.MLPC, redundancy=2,
                               block_words=64), jax_mesh("mesh81"))
    p_new, pprot = elastic.rescale_windowed(
        pair.port, pair.pest,
        lambda m: Protector(m, to_torch(pair.cur), port_specs(specs),
                            mode=Mode.MLPC, redundancy=2, block_words=64),
        zone_mesh("mesh81"))
    assert p_new.group_size == 8 and int(pprot.step) == 1
    assert_prot_same(rprot, jax_mesh("mesh81"), pprot)
