"""The Pool facade with `ProtectConfig(window=4)`: the reference's Pool and
the port's side by side on examples/quickstart.py's steps 1-7 (a fault
lands mid-window; recover, scrub and pre-check flush it first), merged-
window transactions, a patch-engine pool fed `dirty_words`, and the window
fields of `stats` / `health`.  After every step the protected fields and
the open window (accumulator or dirty mask, pending count) are
byte-equal."""
import dataclasses

import numpy as np
import pytest

from repro.configs.base import ProtectConfig as RefConfig
from repro.pool import Fault as RefFault
from repro.pool import Pool as RefPool
from repro.runtime import failure as ref_failure
from repro_torch import Fault, Pool, ProtectConfig, convert
from repro_torch.runtime import failure
from tests._torch_ref import (epoch_fields, jax_mesh, jax_specs, key_words,
                              port_specs, to_jax, to_torch, zone_mesh)
from tests.test_torch_pool import (SPECS, Pools, _doubled, _quickstart_state,
                                   _report)
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


class WindowPools(Pools):
    """`Pools` with Pool keyword arguments for both sides (`pool_kw`), and
    the open window compared too."""

    def __init__(self, pool_kw=None, **cfg):
        self.mesh, zmesh = jax_mesh("mesh42"), zone_mesh("mesh42")
        state = _quickstart_state()
        self.ref = RefPool.open(to_jax(state, SPECS, self.mesh),
                                jax_specs(SPECS), mesh=self.mesh,
                                config=RefConfig(**cfg), **(pool_kw or {}))
        self.port = Pool.open(to_torch(state), port_specs(SPECS), mesh=zmesh,
                              config=ProtectConfig(**cfg), device="cpu",
                              **(pool_kw or {}))
        self.check()

    def check(self):
        super().check()
        want = epoch_fields(self.ref._est, self.mesh)
        got = convert.from_port_epoch(self.port._est)
        for k in ("dirty", "pending", "acc"):
            a, b = want[k], got[k]
            assert (a is None) == (b is None), k
            assert a is None or np.asarray(a).tobytes() == b.tobytes(), k
        assert self.ref.engine._since == self.port.engine._since
        rs, ps = self.ref.stats(), self.port.stats()
        for k in ("engine", "window", "max_window", "commits",
                  "aborted_commits", "recoveries", "scrub"):
            assert ps[k] == rs[k], k

    def inject(self, ref_fn, port_fn):
        """A fault landing inside the open window (the reference's
        `Pool.inject`): the window's bookkeeping is kept."""
        rev = self.ref.inject(ref_fn)
        prot, pev = port_fn(self.port.protector, self.port.prot)
        self.port._est = dataclasses.replace(self.port._est, prot=prot)
        self.check()
        return rev, pev


def test_quickstart_steps_1_to_7_at_window_4():
    # 1-2. open: the bulk engine, window metadata mirrored
    pools = WindowPools(mode="mlpc", block_words=64, window=4)
    ref, port, mesh = pools.ref, pools.port, pools.mesh
    assert port.engine.window == 4 and not port.engine.patch
    assert port.engine.replicate_meta and ref.engine.replicate_meta
    assert port.overhead_report() == ref.overhead_report()

    # 3. two transactions: the window stays open (neither declares a page
    # footprint, so the second seals the first's window with a flush)
    state = _quickstart_state()
    for i in range(2):
        state = _doubled(state)
        key, words = key_words(i)
        with ref.transaction(rng_key=key) as rtx:
            rtx.stage(to_jax(state, SPECS, mesh))
        with port.transaction(rng_key=words) as ptx:
            ptx.stage(to_torch(state))
        assert rtx.ok and ptx.ok
        pools.check()
    assert port.engine.needs_flush and port.step == 2
    want = np.asarray(port.state["w_fsdp"]).copy()

    # 4. rank 2 lost mid-window: recover flushes, rebuilds, and bounds the
    # lost window from the survivors' mirrored metadata
    rev, pev = pools.inject(
        lambda p, s: ref_failure.inject_rank_loss(p, s, 2),
        lambda p, s: failure.inject_rank_loss(p, s, 2))
    rrep = ref.recover(RefFault.rank_loss(rev.lost_rank))
    prep = port.recover(Fault.rank_loss(pev.lost_rank))
    assert prep.verified and _report(prep) == _report(rrep)
    assert prep.window_bound == {"pending": 1, "dirty_pages": None,
                                 "digest_verified": True}
    assert port.engine.window == 1               # failure suspicion
    pools.check()
    np.testing.assert_array_equal(np.asarray(port.state["w_fsdp"]), want)

    # 5. silent scribble: detected by scrub, repaired
    pools.inject(
        lambda p, s: ref_failure.inject_scribble(p, s, rank=1,
                                                 word_offsets=[7]),
        lambda p, s: failure.inject_scribble(p, s, rank=1,
                                             word_offsets=[7]))
    rsr, psr = ref.scrub(), port.scrub()
    assert psr.bad_locations == rsr.bad_locations == [(1, 0)]
    assert dataclasses.asdict(psr) == dataclasses.asdict(rsr)
    pools.check()
    np.testing.assert_array_equal(np.asarray(port.state["w_fsdp"]), want)

    # 6. canary abort: state untouched; at window 1 the attempt is a
    # boundary
    zeros = {k: np.zeros_like(v) for k, v in state.items()}
    with ref.transaction() as rtx:
        rtx.watch(ref_failure.smashed_canary_buffer(4096))
        rtx.stage(to_jax(zeros, SPECS, mesh))
    with port.transaction() as ptx:
        ptx.watch(failure.smashed_canary_buffer(4096, device="cpu"))
        ptx.stage(to_torch(zeros))
    assert ptx.aborted and rtx.aborted and port.step == ref.step == 2
    pools.check()

    # 7. telemetry; clean scrubs regrow the window toward its ceiling
    assert port.health().status == ref.health().status == "degraded"
    assert port.health().reasons == ref.health().reasons
    for w in (2, 4):
        ref.scrub()
        port.scrub()
        assert port.engine.window == ref.engine.window == w
        pools.check()
    assert port.health().status == ref.health().status == "green"
    assert port.stats()["engine"] == "deferred"


def test_scrub_and_precheck_flush_the_open_window():
    pools = WindowPools(mode="mlpc", block_words=64, window=4, redundancy=2)
    ref, port = pools.ref, pools.port
    state = _quickstart_state()
    for step in ("scrub", "precheck"):
        for i in range(2):
            state = _doubled(state)
            pools.commit(state, data_cursor=i)
        assert port.engine.needs_flush
        rr, pr = getattr(ref, step)(), getattr(port, step)()
        assert not port.engine.needs_flush and not pr.suspect
        assert dataclasses.asdict(pr) == dataclasses.asdict(rr)
        pools.check()
    assert port.metrics.counter("pool_window_flush_total").value == \
        ref.metrics.counter("pool_window_flush_total").value == 2


def test_merged_window_transactions_coalesce_and_serialize():
    """Disjoint footprints coalesce into the open window; an overlapping or
    undeclared footprint seals it with a flush first."""
    pools = WindowPools(mode="mlpc", block_words=64, window=8)
    ref, port, mesh = pools.ref, pools.port, pools.mesh
    state = _quickstart_state()
    for pages in ([0], [1, 2], [3], [2, 3], None, [0]):
        state = _doubled(state)
        with ref.transaction(pages=pages) as rtx:
            rtx.stage(to_jax(state, SPECS, mesh))
        with port.transaction(pages=pages) as ptx:
            ptx.stage(to_torch(state))
        assert rtx.ok and ptx.ok and ptx.pages == rtx.pages
        pools.check()
    for name in ("pool_txn_coalesced_total", "pool_txn_serialized_total",
                 "pool_window_flush_total"):
        assert port.metrics.counter(name).value == \
            ref.metrics.counter(name).value, name
    assert port.metrics.counter("pool_txn_coalesced_total").value == 2
    assert port.metrics.counter("pool_txn_serialized_total").value == 3


def test_patch_engine_pool_with_dirty_words():
    """`dirty_leaf_idx` as a callable of the layout: w_tp (leaf 2) is the
    static dirty leaf; commits name its changed words, or none (the whole
    leaf); `dirty_pages` is ignored by the engine; verify_old is refused."""
    pools = WindowPools(
        pool_kw=dict(dirty_leaf_idx=lambda lo: [len(lo.slots) - 1]),
        mode="mlp", block_words=64, window=3, redundancy=2)
    ref, port = pools.ref, pools.port
    assert port.engine.patch and port.engine.dirty_leaf_idx == (2,)
    assert not port.engine.replicate_meta
    state = _quickstart_state()
    n_words = port.protector.layout.slots[2].n_words
    for i in range(5):
        w_tp = np.asarray(state["w_tp"]).copy()
        w_tp[i] = w_tp[i] * 3                  # row i of every model shard
        state = dict(state, w_tp=w_tp)
        words = (None if i % 2 else
                 (np.arange(8 * i, 8 * i + 8, dtype=np.int32),))
        pools.commit(state, dirty_words=words, dirty_pages=[0],
                     rng_key=None, data_cursor=i)
    assert n_words == 8 * 16 // 2
    with pytest.raises(ValueError, match="verify_old"):
        port.commit(to_torch(state), verify_old=True)
    port.flush()
    ref.flush()
    pools.check()
