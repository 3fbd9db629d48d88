"""The multi-tenant `PoolGroup` (repro_torch.tenancy) against the
reference's, on the same numpy states: the tenant-batched kernel entry
points against the reference's in interpret mode; batched commit waves
across windows {1, 4} x r {1, 3} with a canary abort; verify_old and the
looped fallback; the scheduler's scrubs and a quarantined recovery;
quarantine after a budget refusal; LRU eviction with its flush; the
scheduler's served order under a page budget and skewed weights; QoS
cohort keys; tenant labels; waves through the group's ring; the waves'
stacks (reused without a copy, let go by idle and evicted tenants); an
engine arrival hook keeping its tenant off the batched wave.  Every
tenant's protected fields, the redo log included, are byte-equal to the
reference tenant's."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ProtectConfig as RefConfig
from repro.core import gf as ref_gf
from repro.kernels import ops as ref_ops
from repro.pool import Fault as RefFault
from repro.runtime import failure as ref_failure
from repro.tenancy import BRONZE as REF_BRONZE
from repro.tenancy import GOLD as REF_GOLD
from repro.tenancy import PoolGroup as RefGroup
from repro_torch import Fault, ProtectConfig, convert
from repro_torch.kernels import ops
from repro_torch.runtime import failure
from repro_torch.tenancy import (BRONZE, GOLD, PRESETS, SILVER, PoolGroup,
                                 cohort_key)
from tests._torch_ref import (as_words, assert_prot_same, eq_words,
                              epoch_fields, jax_mesh, jax_specs, key_words,
                              port_specs, rand_u32, small_state_np,
                              state_like, to_jax, to_torch, zone_mesh)
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

MESH = "mesh42"


@functools.lru_cache(maxsize=None)
def _setup():
    state, specs = small_state_np()
    return jax_mesh(MESH), zone_mesh(MESH), state, specs


def _tstate(t, i=0):
    """Tenant t's state at wave i (numpy, seeded)."""
    return state_like(1000 * (t + 1) + i, _setup()[2])


class Groups:
    """A reference and a port PoolGroup with the same tenants."""

    def __init__(self, n=0, group_kw=None, admit_kw=None, **cfg):
        self.mesh, zmesh, _, self.specs = _setup()
        self.ref = RefGroup(self.mesh, **(group_kw or {}))
        self.port = PoolGroup(zmesh, device="cpu", **(group_kw or {}))
        for t in range(n):
            self.admit(f"t{t}", _tstate(t), **(admit_kw or {}),
                       **({"config": (RefConfig(**cfg), ProtectConfig(**cfg))}
                          if cfg else {}))

    def admit(self, tid, state, config=None, ref_qos=None, qos=None,
              **kw):
        rkw, pkw = dict(kw), dict(kw)
        if config is not None:
            rkw["config"], pkw["config"] = config
        self.ref.admit(tid, to_jax(state, self.specs, self.mesh),
                       jax_specs(self.specs), qos=ref_qos, **rkw)
        return self.port.admit(tid, to_torch(state), port_specs(self.specs),
                               qos=qos, **pkw)

    def commit(self, updates, *, keys=None, **kw):
        rk = pk = None
        if keys is not None:
            rk = {tid: key_words(s)[0] for tid, s in keys.items()}
            pk = {tid: key_words(s)[1] for tid, s in keys.items()}
        rok = self.ref.commit({tid: to_jax(st, self.specs, self.mesh)
                               for tid, st in updates.items()},
                              rng_keys=rk, **kw)
        pok = self.port.commit({tid: to_torch(st)
                                for tid, st in updates.items()},
                               rng_keys=pk, **kw)
        assert rok.keys() == pok.keys()
        for tid in rok:
            assert bool(pok[tid]) == bool(jax.device_get(rok[tid])), tid
        return pok

    def check(self, tids=None):
        assert self.port.tenants == self.ref.tenants
        for tid in (self.ref.tenants if tids is None else tids):
            rp, pp = self.ref[tid].pool, self.port[tid].pool
            assert_prot_same(rp.prot, self.mesh, pp.prot)
            if rp.engine is not None:
                want = epoch_fields(rp._est, self.mesh)
                got = convert.from_port_epoch(pp._est)
                for k in ("pending", "acc"):
                    assert np.asarray(want[k]).tobytes() == \
                        got[k].tobytes(), (tid, k)
                assert rp.engine._since == pp.engine._since
            rs, ps = rp.stats(), pp.stats()
            for k in ("commits", "aborted_commits", "window", "scrub"):
                assert ps[k] == rs[k], (tid, k)
        assert self.port.quarantined == self.ref.quarantined
        for name in ("group_commit_batches_total",
                     "group_commit_rejected_total"):
            assert self.port.metrics.counter(name).value == \
                self.ref.metrics.counter(name).value, name


# -- the tenant-batched entry points ---------------------------------------------


@pytest.mark.parametrize("r", [1, 3])
def test_tb_entry_points_match_the_reference(r):
    """Each `_tb` entry point on (T, n, bw) pages against the reference's
    in interpret mode (the coefficients a rank's row of a G = 100 zone,
    tiled over T in the port)."""
    t, n, bw = 3, 8, 64
    old, new, acc = (rand_u32((t, n, bw), s) for s in (1, 2, 3))
    stored = np.asarray(ref_ops.fletcher_blocks(
        jnp.asarray(old.reshape(-1, bw)), interpret=True)).reshape(t, n, 2)
    stored = stored.copy()
    stored[1, ::2, 0] ^= 1
    co = ref_gf.syndrome_array(100, r)[99] if r > 1 else None
    pco = None if co is None else as_words(co)
    jo, jn, js, ja = (jnp.asarray(a) for a in (old, new, stored, acc))
    po, pn, ps, pa = (as_words(a) for a in (old, new, stored, acc))
    jco = None if co is None else jnp.asarray(co)
    eq_words(ops.fletcher_blocks_tb(pn),
             ref_ops.fletcher_blocks_tb(jn, interpret=True))
    for got, want in zip(ops.fused_commit_s_tb(po, pn, pco),
                         ref_ops.fused_commit_s_tb(jo, jn, jco,
                                                   interpret=True)):
        eq_words(got, want)
    for got, want in zip(ops.fused_verify_commit_s_tb(po, pn, ps, pco),
                         ref_ops.fused_verify_commit_s_tb(
                             jo, jn, js, jco, interpret=True)):
        eq_words(got, want)
    for got, want in zip(ops.fused_accum_commit_tb(pa, po, pn),
                         ref_ops.fused_accum_commit_tb(ja, jo, jn,
                                                       interpret=True)):
        eq_words(got, want)
    rows = new.reshape(t, -1)
    eq_words(ops.syndrome_scale_tb(as_words(rows), pco),
             ref_ops.syndrome_scale_tb(jnp.asarray(rows), jco,
                                       interpret=True))


# -- batched waves == the reference's, engines x redundancies --------------------


@pytest.mark.parametrize("window,red", [(1, 1), (1, 3), (4, 1), (4, 3)])
def test_group_waves_bit_identical(window, red):
    """Waves over one cohort of three tenants, tenant 1's canary failing
    in wave 1: every tenant's fields, the redo log and the open window
    byte-equal to the reference's after every wave; one batch a wave."""
    g = Groups(3, mode="mlpc", redundancy=red, window=window,
               block_words=64)
    assert len(g.port.cohorts) == 1
    for i in range(2 * window + 1):
        ups = {f"t{t}": _tstate(t, i + 1) for t in range(3)}
        can = {f"t{t}": not (i == 1 and t == 1) for t in range(3)}
        oks = g.commit(ups, canary_ok=can, data_cursor=i,
                       keys={f"t{t}": 100 * t + i for t in range(3)})
        assert not bool(oks["t1"]) if i == 1 else all(
            bool(v) for v in oks.values())
        g.check()
    assert g.port.metrics.counter("group_commit_batches_total").value == \
        2 * window + 1


def test_verify_old_wave_and_looped_fallback():
    """verify_old rides the batched verify sweep; `batched=False` loops
    through each tenant's pool: both byte-equal to the reference's batched
    waves, with tenant 0's state scribbled so that its verify aborts."""
    g = Groups(2, mode="mlpc", redundancy=3, block_words=64)
    loop = Groups(2, mode="mlpc", redundancy=3, block_words=64)
    for grp in (g, loop):
        grp.commit({f"t{t}": _tstate(t, 1) for t in range(2)})
        rp, pp = grp.ref["t0"].pool, grp.port["t0"].pool
        rp.prot, _ = ref_failure.inject_scribble(rp.protector, rp.prot,
                                                 rank=1, word_offsets=[7])
        pp.prot, _ = failure.inject_scribble(pp.protector, pp.prot,
                                             rank=1, word_offsets=[7])
    for i in range(2):
        ups = {f"t{t}": _tstate(t, i + 2) for t in range(2)}
        oks = g.commit(ups, data_cursor=i, verify_old=True)
        assert not bool(oks["t0"]) and bool(oks["t1"])
        loop.ref.commit({tid: to_jax(st, g.specs, g.mesh)
                         for tid, st in ups.items()}, data_cursor=i,
                        verify_old=True)
        loop.port.commit({tid: to_torch(st) for tid, st in ups.items()},
                         data_cursor=i, verify_old=True, batched=False)
        g.check()
        for tid in ("t0", "t1"):
            assert_prot_same(loop.ref[tid].pool.prot, g.mesh,
                             loop.port[tid].pool.prot)
            assert_prot_same(g.ref[tid].pool.prot, g.mesh,
                             loop.port[tid].pool.prot)
    assert loop.port.metrics.counter(
        "group_commit_batches_total").value == 1       # the first wave


def test_scheduled_scrubs_and_quarantined_recovery():
    """Scheduler scrubs and a quarantined recovery of tenant 1 go through
    its own pool: byte-equal to the reference's; the neighbours'
    protection untouched."""
    g = Groups(3, group_kw={"full_scrub_every": 1}, mode="mlpc",
               redundancy=2, block_words=64)
    for i in range(2):
        g.commit({f"t{t}": _tstate(t, i + 1) for t in range(3)},
                 data_cursor=i, keys={f"t{t}": 100 * t + i
                                      for t in range(3)})
    rs, ps = g.ref.scrub_tick(), g.port.scrub_tick()
    assert [(tid, kind, rep.suspect) for tid, kind, rep in ps] == \
        [(tid, kind, rep.suspect) for tid, kind, rep in rs]
    assert {tid for tid, _, _ in ps} == {"t0", "t1", "t2"}
    g.check()
    rp, pp = g.ref["t1"].pool, g.port["t1"].pool
    rp.inject(lambda p, pr: ref_failure.inject_rank_loss(p, pr, 2))
    pp.prot, _ = failure.inject_rank_loss(pp.protector, pp.prot, 2)
    before = {t: g.port[t].pool.prot.row.clone() for t in ("t0", "t2")}
    rrep = g.ref.recover("t1", RefFault.rank_loss(2))
    prep = g.port.recover("t1", Fault.rank_loss(2))
    assert prep.verified and rrep.verified and g.port.quarantined == ()
    g.check()
    for t, row in before.items():
        assert torch.equal(g.port[t].pool.prot.row, row)


def test_quarantine_rejects_commits_until_release():
    """A budget refusal leaves the tenant quarantined: its update is
    rejected with a host False while its neighbour commits in the same
    wave; after a re-arm, `release` lets it commit again."""
    g = Groups(2, mode="mlpc", redundancy=1, block_words=64)
    with pytest.raises(RuntimeError, match="budget exhausted"):
        g.ref.recover("t0", RefFault.multi_loss(0, 1))
    with pytest.raises(RuntimeError, match="budget exhausted"):
        g.port.recover("t0", Fault.multi_loss(0, 1))
    assert g.port.quarantined == ("t0",)
    assert g.port.health()["status"] != "green"
    oks = g.commit({f"t{t}": _tstate(t, 1) for t in range(2)})
    assert oks["t0"] is False and bool(oks["t1"])
    g.check()
    for grp, conv in ((g.ref, lambda s: to_jax(s, g.specs, g.mesh)),
                      (g.port, to_torch)):
        grp["t0"].pool.init(conv(_tstate(0, 1)))
        grp.release("t0")
    oks = g.commit({"t0": _tstate(0, 2)})
    assert bool(oks["t0"]) and g.port["t0"].pool.step == 1
    g.check()


def test_lru_eviction_flushes_the_open_window():
    """At capacity the least recently committed tenant is evicted, its
    open window flushed first: the state handed back equals the
    reference's, and a pre-check of the evicted pool is clean."""
    g = Groups(0, group_kw={"capacity": 2})
    cfg = dict(mode="mlpc", redundancy=1, window=4, block_words=64)
    for t in range(2):
        g.admit(f"t{t}", _tstate(t), config=(RefConfig(**cfg),
                                              ProtectConfig(**cfg)))
    g.commit({"t0": _tstate(0, 1), "t1": _tstate(1, 1)})
    g.commit({"t0": _tstate(0, 2)})
    victim = g.port["t1"]
    assert victim.pool.engine._since == 1
    ref_victim = g.ref["t1"]
    g.admit("t2", _tstate(2), config=(RefConfig(**cfg), ProtectConfig(**cfg)))
    assert g.port.tenants == ("t0", "t2") == g.ref.tenants
    assert victim.pool.engine._since == 0
    assert not victim.pool.precheck().suspect
    assert_prot_same(ref_victim.pool.prot, g.mesh, victim.pool.prot)
    g.check()
    assert g.port.metrics.counter("group_evictions_total").value == 1
    strict = PoolGroup(g.port.mesh, capacity=1, evict_on_full=False,
                       device="cpu")
    strict.admit("x", to_torch(_tstate(0)), port_specs(g.specs))
    with pytest.raises(RuntimeError, match="capacity"):
        strict.admit("y", to_torch(_tstate(1)), port_specs(g.specs))


def test_scheduler_served_order_under_budget_and_weights():
    """One pool's pages a tick and tenant 0 weighted x8: the port's
    scheduler serves the reference's tenants in the reference's order,
    each tenant gets both kinds of pass, and the ages stay bounded."""
    n = 3
    g = Groups(0, group_kw={"full_scrub_every": 2})
    cfg = dict(mode="mlpc", redundancy=1, block_words=64)
    for t in range(n):
        g.admit(f"t{t}", _tstate(t), config=(RefConfig(**cfg),
                                              ProtectConfig(**cfg)),
                weight=8 if t == 0 else 1)
    pages = g.port["t0"].pool.scrubber.pool_pages
    kinds = {f"t{t}": set() for t in range(n)}
    for rnd in range(4 * n):
        g.commit({f"t{t}": _tstate(t, rnd + 1) for t in range(n)})
        rs = g.ref.scrub_tick(page_budget=pages)
        ps = g.port.scrub_tick(page_budget=pages)
        assert [(tid, kind) for tid, kind, _ in ps] == \
            [(tid, kind) for tid, kind, _ in rs]
        for tid, kind, rep in ps:
            kinds[tid].add(kind)
            assert not rep.suspect
        assert g.port.scheduler.max_check_age() == \
            g.ref.scheduler.max_check_age() <= 2 * n + 1
    assert all(k == {"precheck", "full"} for k in kinds.values())
    assert g.port.scheduler.stats() == g.ref.scheduler.stats()
    g.check()
    g.port.scheduler.set_quarantined("t0", True)
    assert "t0" not in {tid for tid, _, _ in g.port.scrub_tick()}


def test_qos_classes_key_cohorts():
    """Same shape and class: one cohort and one Protector; another class
    or config: its own cohort, as in the reference; mixed cohorts commit
    in one wave."""
    g = Groups(0)
    a = g.admit("a", _tstate(0), ref_qos=REF_GOLD, qos=GOLD)
    b = g.admit("b", _tstate(1), ref_qos=REF_GOLD, qos=GOLD)
    c = g.admit("c", _tstate(2), ref_qos=REF_BRONZE, qos=BRONZE)
    assert a.cohort is b.cohort and a.cohort is not c.cohort
    assert a.pool.protector is b.pool.protector
    assert a.pool.redundancy == 3 and a.pool.engine is None
    assert c.pool.engine is not None and c.pool.engine.window == 8
    assert g.port.scheduler._tenants["a"].weight == GOLD.weight == 4
    d = g.port.admit("d", to_torch(_tstate(3)), port_specs(g.specs),
                     qos=SILVER.configure(block_words=64))
    assert d.cohort not in (a.cohort, c.cohort) and len(g.port.cohorts) == 3
    assert set(PRESETS) == {"gold", "silver", "bronze"}
    state = to_torch(_tstate(0))
    assert cohort_key(state, port_specs(g.specs), GOLD.config) == \
        cohort_key(to_torch(_tstate(5)), port_specs(g.specs), GOLD.config)
    assert cohort_key(state, port_specs(g.specs), GOLD.config) != \
        cohort_key(state, port_specs(g.specs), SILVER.config)
    g.port.evict("d")
    g.commit({t: _tstate(i, 1) for i, t in enumerate("abc")})
    g.check()


def test_tenant_metric_labels():
    g = Groups(2, mode="mlpc", redundancy=1, block_words=64)
    g.commit({f"t{t}": _tstate(t, 1) for t in range(2)})
    for t in range(2):
        assert g.port.metrics.counter("pool_commits_total",
                                      tenant=f"t{t}").value == 1
        names = {name for name, _, _ in g.port[f"t{t}"].pool.metrics.collect()}
        assert "pool_commits_total" in names
    snap = g.port.metrics.snapshot()
    assert any("tenant=t0" in k for k in snap.get("pool_commits_total", {}))
    st = g.port.stats()
    assert st["tenants"] == 2 and st["per_tenant"]["t0"]["commits"] == 1
    assert g.port.health()["status"] == "green"


def test_waves_through_the_group_ring():
    """`commit_async` sends each wave through the group's ring as one
    ticket: its verdict the AND of the tenants', `extras["verdicts"]` the
    per-tenant map (a quarantined tenant's host False among them)."""
    g = Groups(2, group_kw={"pipeline_depth": 2}, mode="mlpc",
               redundancy=1, block_words=64)
    tickets = []
    for k in range(1, 4):
        ups = {f"t{t}": _tstate(t, k) for t in range(2)}
        g.ref.commit_async({tid: to_jax(st, g.specs, g.mesh)
                            for tid, st in ups.items()})
        tickets.append(g.port.commit_async(
            {tid: to_torch(st) for tid, st in ups.items()}))
        assert len(g.port._ring) <= 2
    assert g.port.drain() == tickets[1:] and tickets[0].resolved
    g.ref.drain()
    for t in tickets:
        assert t.result() is True
        assert set(t.extras["verdicts"]) == {"t0", "t1"}
    assert g.port.metrics.histogram("group_wave_resolve_ms").count == 3
    g.check()
    g.port._quarantined.add("t0")
    t = g.port.commit_async({"t0": to_torch(_tstate(0, 9)),
                             "t1": to_torch(_tstate(1, 9))})
    assert t.extras["verdicts"]["t0"] is False and t.result() is False


# -- the waves' stacks: reused without a copy, never held by an idle tenant -------


def _own_bytes(t):
    """`t` is all its storage holds: no wave's (T, ...) stack behind it."""
    return t.untyped_storage().nbytes() == t.nbytes


def _fields(pool):
    p = pool.prot
    out = {"row": p.row, "digest": p.digest, "synd": p.synd,
           "cksums": p.cksums}
    if pool.engine is not None:
        out["acc"] = pool._est.acc
    return out


@pytest.mark.parametrize("window", [1, 4])
def test_an_idle_tenant_lets_go_of_the_wave_stacks(window):
    """After a wave of three tenants, waves of two (one with a canary
    abort) leave tenant 2 idle: its fields become its own bytes, so the
    three-tenant stacks can be freed, while the two committing tenants
    share their wave's stacks, which the next wave reuses without a copy.
    Every wave byte-equal to the reference's."""
    g = Groups(3, mode="mlpc", redundancy=3, window=window, block_words=64)
    g.commit({f"t{t}": _tstate(t, 1) for t in range(3)})
    row = g.port["t0"].pool.prot.row
    assert row.untyped_storage().nbytes() == 3 * row.nbytes
    for i in range(2, 2 * window + 3):
        can = {"t1": i != 3}
        g.commit({f"t{t}": _tstate(t, i) for t in range(2)}, canary_ok=can,
                 data_cursor=i)
        g.check()
        for name, f in _fields(g.port["t2"].pool).items():
            assert _own_bytes(f), name
        if window > 1 and i == 3:          # the abort left the step's stacks
            assert _own_bytes(g.port["t1"].pool.prot.row)
        elif window == 1 or i > 3:
            for t in range(2):
                row = g.port[f"t{t}"].pool.prot.row
                assert row.untyped_storage().nbytes() == 2 * row.nbytes
            # the next wave of the two stacks their fields without a copy
            cohort = g.port["t0"].cohort
            for name in ("row", "acc") if window > 1 else ("row", "synd"):
                ptr = _fields(g.port["t0"].pool)[name].untyped_storage()
                assert cohort._stacked(name, ["t0", "t1"]).untyped_storage(
                ).data_ptr() == ptr.data_ptr(), name


def test_a_wave_reuses_the_last_wave_stacks_and_eviction_copies_out():
    """The next wave of the same tenants in the same order stacks their
    rows without a copy (the last wave's stack itself); another order
    copies.  Once a looped wave moves every tenant off a stack, nothing
    holds it.  An evicted tenant's pool owns its bytes, and the next wave
    of the rest stays byte-equal to the reference's."""
    g = Groups(3, mode="mlpc", redundancy=3, block_words=64)
    g.commit({f"t{t}": _tstate(t, 1) for t in range(3)})
    cohort = g.port["t0"].cohort
    ptr = g.port["t0"].pool.prot.row.untyped_storage().data_ptr()
    tids = ["t0", "t1", "t2"]
    assert cohort._stacked("row", tids).untyped_storage().data_ptr() == ptr
    assert cohort._stacked("row", tids[::-1]).untyped_storage().data_ptr() \
        != ptr
    g.commit({f"t{t}": _tstate(t, 2) for t in range(3)}, batched=False)
    g.check()
    assert cohort._stacks["row"].stack is None
    g.commit({f"t{t}": _tstate(t, 3) for t in range(3)})
    g.check()
    victim = g.port["t2"]
    g.ref.evict("t2")
    g.port.evict("t2")
    for name, f in _fields(victim.pool).items():
        assert _own_bytes(f), name
    assert not victim.pool.precheck().suspect
    g.commit({f"t{t}": _tstate(t, 4) for t in range(2)})
    g.check()


def test_an_engine_arrival_hook_keeps_its_tenant_off_the_batched_wave():
    """A tenant whose engine has an arrival hook commits through its own
    pool (the hook fires once a commit); its neighbour, alone, too."""
    g = Groups(2, mode="mlpc", redundancy=1, window=4, block_words=64)
    seen = []
    pool = g.port["t0"].pool
    pool.engine.arrival_hook = lambda est, since, due: seen.append(since)
    assert not g.port["t0"].cohort.batchable(pool)
    g.port.commit({f"t{t}": to_torch(_tstate(t, 1)) for t in range(2)})
    g.port.commit({f"t{t}": to_torch(_tstate(t, 2)) for t in range(2)})
    assert seen == [1, 2]
    assert g.port.metrics.counter("group_commit_batches_total").value == 0
