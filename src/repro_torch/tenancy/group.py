"""Multi-tenant `PoolGroup`: many pools, one launch a kernel a wave (the
reference's tenancy/group.py).

A serving host protects many small pools at once.  As N independent
`Pool`s they cost N launches of every kernel a commit wave; the group
collapses that:

  * **Cohorts.**  Tenants whose (state signature x specs x config) match
    share one `Cohort`, with one `Protector` (one zone layout, one
    coefficient table), handed to each tenant's `Pool` through
    `Pool(..., protector=...)`.
  * **Batched commit waves.**  A wave over a cohort's tenants stacks their
    rows with the tenant dim in front of the zone-stacked lead,
    `(T, *mesh_dims, ...)`, launches each kernel once over the T x G ranks
    (`kernels.ops` `_tb` entry points, byte-equal because every kernel is
    per page), folds all T syndrome stacks in one collective call, and
    selects each tenant on its own verdict.  Verdicts, redo records and
    protected states come out byte-equal to T `pool.commit` calls.
  * **Shared scrub scheduler** (`tenancy/scheduler.py`): verification
    pressure round-robins across tenants under a global page budget,
    weighted by QoS class, starvation-free.
  * **Admission control.**  `capacity` bounds the tenant count; at capacity
    `admit` refuses, or evicts the least recently committed tenant
    (flush-before-evict: its open window lands and its state is returned).
  * **Quarantined recovery.**  `group.recover(tid, fault)` quarantines only
    the faulted tenant (its updates are rejected, the others keep
    committing), runs the tenant's own recovery and lifts the quarantine
    on success; a failed recovery leaves it quarantined.

The batched path covers the bulk engines: synchronous bulk commits (no
`dirty_pages`) and bulk deferred steps and flushes, on parity or checksum
modes.  Patch engines, modes without parity and checksums, tenants with an
arrival hook and every rare operation (scrub, pre-check, recover) go
through the tenant's own `Pool`.  Like the reference, the batched waves
launch the flat kernels whatever the row size; the streamed ones are
byte-equal.  The reference's jit caches have no counterpart here: eager
PyTorch compiles nothing, so the batched programs are plain functions.

Telemetry: the group owns one `MetricsRegistry` and one `Tracer`; each
tenant's pool publishes through `registry.labeled(tenant=tid)`.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import utils
from repro_torch.configs.base import ProtectConfig
from repro_torch.core import checksum as ck
from repro_torch.core import layout as layout_mod
from repro_torch.core import redolog
from repro_torch.core.epoch import EpochState
from repro_torch.core.pipeline import CommitRing, CommitTicket
from repro_torch.core.txn import _check_like, select
from repro_torch.dist import collectives as coll
from repro_torch.kernels import ops as kops
from repro_torch.obs import health as obs_health
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.pool import Fault, Pool, protector_for
from repro_torch.tenancy.qos import QoSClass
from repro_torch.tenancy.scheduler import ScrubScheduler

PyTree = Any


def _field(pool: Pool, name: str) -> torch.Tensor:
    """A tenant's protection field: `acc` of its open window, else the
    ProtectedState's field (`row`, `digest`, `synd`, `cksums`)."""
    return pool._est.acc if name == "acc" else getattr(pool.prot, name)


def _set_field(pool: Pool, name: str, value: torch.Tensor) -> None:
    if name == "acc":
        pool._est = dataclasses.replace(pool._est, acc=value)
    elif pool.engine is not None:
        pool._est = dataclasses.replace(pool._est, prot=dataclasses.replace(
            pool._est.prot, **{name: value}))
    else:
        pool._prot = dataclasses.replace(pool._prot, **{name: value})


class WaveStack:
    """A batched wave's `(T, ...)` output of one field, handed out a slice
    a tenant.  The stack is held only while every tenant still holds its
    slice: the first slice to go (a solo commit, a recovery, a newer wave)
    lets go of it, so the tenants' slices alone keep its bytes alive."""

    def __init__(self, stack: torch.Tensor, tids: list, give):
        """`give(tid, view)` hands tenant `tid` its slice."""
        self.stack: Optional[torch.Tensor] = stack
        self.held = {}
        for i, tid in enumerate(tids):
            view = stack[i]
            give(tid, view)
            # weak, so that a tenant dropping its slice is seen here
            self.held[tid] = weakref.ref(view, self._let_go)

    def _let_go(self, _ref) -> None:
        self.stack = None

    def slice_of(self, tid: str) -> Optional[torch.Tensor]:
        """The slice `tid` was handed, while it is still alive."""
        ref = self.held.get(tid)
        return ref() if ref is not None else None

    def reusable(self, tids: list, tensors: list) -> Optional[torch.Tensor]:
        """The stack itself when `tensors` are its slices, all of them, in
        its order; else None."""
        if (self.stack is not None and list(self.held) == list(tids)
                and all(self.held[t]() is x for t, x in zip(tids, tensors))):
            return self.stack
        return None


def cohort_key(state: PyTree, state_specs: PyTree,
               config: ProtectConfig) -> tuple:
    """Tenants sharing this key share a Protector and batched waves: the
    same leaf shapes, dtypes and tree structure, the same specs, the same
    config — what decides a zone layout."""
    leaves, treedef = utils.tree_flatten(state)
    sig = tuple((tuple(l.shape), str(l.dtype)) for l in leaves)
    specs = tuple(str(s) for s in utils.tree_leaves(state_specs))
    return (treedef, sig, specs, config)


@dataclasses.dataclass
class TenantHandle:
    """The group's record of a tenant.  `pool` is a full `Pool` sharing its
    cohort's Protector: every single-tenant operation runs on it directly;
    the group owns batching, scheduling, admission and quarantine."""
    tenant_id: str
    pool: Pool
    cohort: "Cohort"
    qos: Optional[QoSClass]
    weight: int
    last_used: int = 0


class Cohort:
    """Same-shape, same-config tenants: one Protector, batched waves."""

    def __init__(self, mesh, state: PyTree, state_specs: PyTree,
                 config: ProtectConfig, *, name: str = "c0"):
        self.name = name
        self.config = config
        self.protector = protector_for(mesh, state, state_specs, config)
        self.members: Dict[str, Pool] = {}     # insertion order = roster
        # field -> the last wave's WaveStack of it
        self._stacks: Dict[str, WaveStack] = {}

    def batchable(self, pool: Pool) -> bool:
        mode = self.protector.mode
        if not (mode.has_parity or mode.has_cksums):
            return False
        if pool._arrival_fn is not None or (   # chaos hooks: loop path
                pool.engine is not None
                and pool.engine.arrival_hook is not None):
            return False
        return pool.engine is None or not pool.engine.patch

    # -- the waves' stacked outputs ------------------------------------------

    def _stacked(self, name: str, tids: list) -> torch.Tensor:
        """The tenants' `name` fields stacked `(T, ...)`: without a copy when
        they are still the slices the last wave that wrote `name` handed
        out, all of them, in its order."""
        tensors = [_field(self.members[t], name) for t in tids]
        ws = self._stacks.get(name)
        stack = ws.reusable(tids, tensors) if ws is not None else None
        return stack if stack is not None else torch.stack(tensors)

    def _hand_out(self, name: str, tids: list, stack: torch.Tensor) -> None:
        """Give tenant `tids[i]` slice i of a wave's `stack` as its `name`
        field.  A tenant still holding a slice of the previous `name` stack
        that this wave leaves out gets its own copy: the previous stack is
        freed once the wave's tenants let go of it, so an idle tenant keeps
        its own bytes, not T tenants'."""
        prev = self._stacks.get(name)
        if prev is not None:
            prev.stack = None
            for tid in prev.held:
                view = prev.slice_of(tid)
                if (tid not in tids and view is not None
                        and _field(self.members[tid], name) is view):
                    _set_field(self.members[tid], name, view.clone())
        self._stacks[name] = WaveStack(
            stack, tids,
            lambda tid, view: _set_field(self.members[tid], name, view))

    def leave(self, tid: str) -> None:
        """Drop a tenant from the roster (eviction).  Its fields that are
        slices of a wave's stacks become copies of its own, so the pool it
        keeps does not hold its former cohort's stacks."""
        pool = self.members.pop(tid)
        for name, ws in self._stacks.items():
            if tid not in ws.held:
                continue
            view = ws.slice_of(tid)
            ws.stack = None                # no longer every holder's
            del ws.held[tid]
            if view is not None and _field(pool, name) is view:
                _set_field(pool, name, view.clone())

    # -- helpers of the batched waves --------------------------------------

    def _stack_rows(self, states: list, device) -> torch.Tensor:
        """`(T, *mesh_dims, row_words)`: each state's row flattened straight
        into its slice (one copy a row, as a single pool's flatten)."""
        lo = self.protector.layout
        out = torch.empty(len(states), *self.protector.mesh.shape,
                          lo.row_words, dtype=utils.WORD, device=device)
        for i, st in enumerate(states):
            layout_mod.flatten_row(lo, st, out=out[i])
        return out

    def _pages(self, rows: torch.Tensor) -> torch.Tensor:
        return rows.reshape(*rows.shape[:-1], -1,
                            self.protector.layout.block_words)

    def _zone_all(self, ok: torch.Tensor) -> torch.Tensor:
        """Each tenant's zone agreement, over the data dim only (the
        reference's per-tenant `pmin` over the data axis)."""
        dd = 1 + self.protector.data_dim
        return ok.all(dim=dd, keepdim=True).expand_as(ok)

    # -- batched synchronous commit -----------------------------------------

    def _sync_wave(self, tids: list, states_new: list, canaries: tuple,
                   verify_old: bool) -> tuple:
        """`Protector.make_commit`'s bulk path with a leading tenant dim:
        one launch a kernel over (T, *mesh_dims) ranks, the T syndrome
        stacks folded in one collective call, each tenant selected on its
        own verdict.  Returns (T, *mesh_dims) verdicts and the stacked
        selected (row, digest, synd, cksums)."""
        p = self.protector
        mode, bw, dd = p.mode, p.layout.block_words, 1 + p.data_dim
        prots = [self.members[tid]._prot for tid in tids]
        dev = prots[0].step.device
        coeffs = p.coeffs(dev)
        ok = torch.ones(len(tids), *p.mesh.shape, dtype=torch.bool,
                        device=dev)
        for i, canary in enumerate(canaries):
            if not canary:
                ok[i] = False
        # with verify_old the old rows re-flatten from the live states (a
        # scribble lives in the state; a clean cache would launder it)
        rows_old = (self._stack_rows([pr.state for pr in prots], dev)
                    if verify_old else self._stacked("row", tids))
        rows_new = self._stack_rows(states_new, dev)
        synd_old = (self._stacked("synd", tids) if mode.has_parity
                    else None)
        cks_old = (self._stacked("cksums", tids) if mode.has_cksums
                   else None)
        synd_new = synd_old
        if verify_old and mode.has_cksums:
            sdelta, fresh, bad = kops.fused_verify_commit_s_tb(
                self._pages(rows_old), self._pages(rows_new), cks_old,
                coeffs)
            ok = self._zone_all(ok & ~bad.any(dim=-1))
            del bad
            if mode.has_parity:
                synd_new = coll.syndrome_apply_delta(synd_old, sdelta, dd)
        else:
            fresh = kops.fletcher_blocks_tb(self._pages(rows_new))
            if mode.has_parity:
                # the stack of the new rows: a fold of their weighted planes
                sdelta = kops.syndrome_scale_tb(rows_new, coeffs)
                synd_new = coll.xor_reduce_scatter(sdelta, dd)
        if mode.has_parity:
            del sdelta
        row = select(ok, rows_new, rows_old)
        del rows_new, rows_old
        digest = select(ok, ck.combine(fresh, bw),
                        self._stacked("digest", tids))
        synd = (select(ok, synd_new, synd_old) if mode.has_parity
                else None)
        cksums = select(ok, fresh, cks_old) if mode.has_cksums else None
        return ok, row, digest, synd, cksums

    def commit_sync(self, items: list, *, verify_old: bool = False) -> dict:
        """Batched commit for synchronous-engine tenants.

        `items`: [(tid, state_new, canary_ok, data_cursor, rng_key)] in
        roster order.  Returns {tid: 0-d device verdict}.  A canary-aborted
        tenant keeps its state and gets its redo record appended unmarked,
        as `Protector.commit` does."""
        t0 = time.perf_counter()
        tids = [it[0] for it in items]
        pools = [self.members[tid] for tid in tids]
        states = [pool.to_zone(it[1]) for pool, it in zip(pools, items)]
        for st, pool in zip(states, pools):
            _check_like(st, pool._prot.state)
        canaries = tuple(bool(it[2]) for it in items)
        ok, row, digest, synd, cksums = self._sync_wave(
            tids, states, canaries, verify_old)
        mode = self.protector.mode
        out = {}
        for i, (pool, it) in enumerate(zip(pools, items)):
            pr = pool._prot
            ok_dev = ok[i]
            ok_i = ok_dev.reshape(-1)[0]
            step = pr.step + 1
            log = pr.log
            if mode.has_log:
                log = redolog.append(pr.log, step, it[3],
                                     (0, 0) if it[4] is None else it[4],
                                     digest[i].reshape(-1, 2)[0])
                marked = redolog.commit_mark(log, step)
                log = dataclasses.replace(log, mark=torch.where(
                    ok_i, marked.mark, log.mark))
            pool._prot = dataclasses.replace(
                pr, state=utils.tree_map(lambda n, o: select(ok_dev, n, o),
                                         states[i], pr.state),
                log=log, step=torch.where(ok_i, step, pr.step))
            out[it[0]] = ok_i
        for name, stack in (("row", row), ("digest", digest),
                            ("synd", synd), ("cksums", cksums)):
            if stack is not None:
                self._hand_out(name, tids, stack)
        ms = (time.perf_counter() - t0) * 1e3 / len(items)
        for pool, can in zip(pools, canaries):
            pool._note_commit(can, ms)
        return out

    # -- batched deferred step + flush --------------------------------------

    def _step_wave(self, tids: list, states_new: list) -> tuple:
        """`DeferredProtector.make_step_commit`'s bulk step for the live
        tenants, stacked: one accumulate sweep over (Tl, *mesh_dims) ranks.
        Returns the stacked (new rows, accumulators, new terms, digests)."""
        bw = self.protector.layout.block_words
        old = self._stacked("row", tids)
        rows_new = self._stack_rows(states_new, old.device)
        acc, _, new_ck = kops.fused_accum_commit_tb(
            self._pages(self._stacked("acc", tids)), self._pages(old),
            self._pages(rows_new))
        del old
        return (rows_new, acc.reshape(rows_new.shape), new_ck,
                ck.combine(new_ck, bw))

    def _flush_wave(self, tids: list) -> tuple:
        """`make_flush`'s bulk branch for the tenants whose windows came
        due: every accumulator weighted into its planes in one launch and
        the stacks folded in one collective call.  Returns their stacks
        (None without parity) and fresh zero accumulators."""
        p = self.protector
        acc = self._stacked("acc", tids)
        synd = None
        if p.mode.has_parity:
            synd = coll.syndrome_apply_delta(
                self._stacked("synd", tids),
                kops.syndrome_scale_tb(acc, p.coeffs(acc.device)),
                1 + p.data_dim)
        return synd, torch.zeros_like(acc)

    def commit_deferred(self, items: list) -> dict:
        """Batched commit for bulk deferred-engine tenants: one stacked
        step over the live tenants, then one stacked flush over exactly
        the tenants whose windows came due.  The host cadence is each
        engine's own (`count_attempt`, `note_flush`, `mirror`), in
        `DeferredProtector.commit`'s order, then `Pool.commit`'s
        bookkeeping."""
        t0 = time.perf_counter()
        tids = [it[0] for it in items]
        pools = [self.members[tid] for tid in tids]
        states = [pool.to_zone(it[1]) for pool, it in zip(pools, items)]
        canaries = tuple(bool(it[2]) for it in items)
        live = [i for i, c in enumerate(canaries) if c]
        mode = self.protector.mode
        oks = {}
        if live:
            for i in live:
                _check_like(states[i], pools[i]._est.prot.state)
            live_tids = [tids[i] for i in live]
            rows, accs, new_ck, digests = self._step_wave(
                live_tids, [states[i] for i in live])
            for j, i in enumerate(live):
                est, it = pools[i]._est, items[i]
                pr = est.prot
                step = pr.step + 1
                log = pr.log
                if mode.has_log:
                    # the record persists per step, marked at once
                    log = redolog.append(
                        log, step, it[3], (0, 0) if it[4] is None else it[4],
                        digests[j].reshape(-1, 2)[0])
                    log = redolog.commit_mark(log, step)
                pools[i]._est = EpochState(
                    prot=dataclasses.replace(pr, state=states[i], log=log,
                                             step=step),
                    dirty=None, pending=est.pending + 1, acc=est.acc)
                oks[i] = torch.ones((), dtype=torch.bool, device=step.device)
            for name, stack in (("row", rows), ("digest", digests),
                                ("acc", accs),
                                ("cksums", new_ck if mode.has_cksums
                                 else None)):
                if stack is not None:
                    self._hand_out(name, live_tids, stack)
            del rows, accs, new_ck, digests
        due = []
        for i, pool in enumerate(pools):
            if i not in oks:          # a canary abort leaves the window as is
                oks[i] = torch.zeros((), dtype=torch.bool,
                                     device=pool._est.prot.step.device)
            if pool.engine.count_attempt():
                due.append(tids[i])
        if due:
            synd, zeros = self._flush_wave(due)
            for tid in due:
                pool = self.members[tid]
                pool.engine.note_flush()
                pool._est = dataclasses.replace(
                    pool._est, dirty=None,
                    pending=torch.zeros_like(pool._est.pending))
            for name, stack in (("synd", synd), ("acc", zeros)):
                if stack is not None:
                    self._hand_out(name, due, stack)
        ms = (time.perf_counter() - t0) * 1e3 / len(items)
        out = {}
        for i, (pool, it) in enumerate(zip(pools, items)):
            pool.engine.mirror(pool._est)
            pool._note_commit(canaries[i], ms)
            out[it[0]] = oks[i]
        return out


class PoolGroup:
    """The multi-tenant front door: admit / commit / scrub_tick / recover /
    evict / rescale over a fleet of cohort-sharing pools on one device
    (`device`, the card unless the caller asks for the CPU)."""

    def __init__(self, mesh, *, capacity: int = 0,
                 evict_on_full: bool = True, scrub_page_budget: int = 0,
                 full_scrub_every: int = 4, pipeline_depth: int = 1,
                 device=None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        if capacity < 0:
            raise ValueError(f"capacity={capacity}: 0 (unbounded) or more")
        self.mesh = mesh
        self.device = utils.resolve_device(device)
        self.capacity = int(capacity)          # 0 = unbounded
        self.evict_on_full = bool(evict_on_full)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        # commit_async sends whole waves through this ring, a ticket a wave
        self.pipeline_depth = int(pipeline_depth)
        self._ring = CommitRing(
            self.pipeline_depth,
            on_depth=self.metrics.gauge("group_inflight_waves").set)
        self._ticket_seq = 0
        self.scheduler = ScrubScheduler(page_budget=scrub_page_budget,
                                        full_every=full_scrub_every)
        self._cohorts: Dict[tuple, Cohort] = {}
        self._tenants: Dict[str, TenantHandle] = {}
        self._quarantined: set = set()
        self._clock = 0
        self._m_admit = self.metrics.counter("group_admissions_total")
        self._m_evict = self.metrics.counter("group_evictions_total")
        self._m_batches = self.metrics.counter("group_commit_batches_total")
        self._m_rejected = self.metrics.counter(
            "group_commit_rejected_total")

    # -- membership ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self._tenants)

    def __contains__(self, tid) -> bool:
        return tid in self._tenants

    def __getitem__(self, tid) -> TenantHandle:
        return self._tenants[tid]

    @property
    def tenants(self) -> Tuple[str, ...]:
        return tuple(self._tenants)

    @property
    def quarantined(self) -> Tuple[str, ...]:
        return tuple(sorted(self._quarantined))

    @property
    def cohorts(self) -> Tuple[Cohort, ...]:
        return tuple(self._cohorts.values())

    def admit(self, tid: str, state: PyTree, specs: PyTree, *,
              config: Optional[ProtectConfig] = None,
              qos: Optional[QoSClass] = None,
              weight: Optional[int] = None, **pool_kw) -> TenantHandle:
        """Admit a tenant (the multi-tenant `pgl_open`) and protect its
        global `state`.  A state of `device="meta"` tensors
        (`utils.abstract`) admits a cold tenant: its pool is built and not
        initialised (call `handle.pool.init(state)` later).  The config
        comes from `config`, else the QoS class, else the defaults; the QoS
        weight feeds the scrub scheduler.  At capacity the least recently
        committed tenant is evicted (flush-before-evict) when
        `evict_on_full`, else admission raises."""
        if tid in self._tenants:
            raise ValueError(f"tenant {tid!r} already admitted")
        if self.capacity and len(self._tenants) >= self.capacity:
            if not self.evict_on_full:
                raise RuntimeError(
                    f"group at capacity ({self.capacity} tenants) and "
                    "evict_on_full=False — evict explicitly or raise "
                    "capacity")
            victims = [t for t in self._tenants
                       if t not in self._quarantined]
            if not victims:
                raise RuntimeError(
                    "group at capacity with every tenant quarantined — "
                    "nothing is safely evictable")
            self.evict(min(victims,
                           key=lambda t: self._tenants[t].last_used))
        if config is None:
            config = qos.config if qos is not None else ProtectConfig()
        state = utils.tree_map(torch.as_tensor, state)
        key = cohort_key(state, specs, config)
        cohort = self._cohorts.get(key)
        if cohort is None:
            cohort = Cohort(self.mesh, state, specs, config,
                            name=f"c{len(self._cohorts)}")
            self._cohorts[key] = cohort
        pool = Pool(self.mesh, state, specs, config, device=self.device,
                    metrics=self.metrics.labeled(tenant=str(tid)),
                    tracer=self.tracer, protector=cohort.protector,
                    **pool_kw)
        if not utils.is_abstract(state):
            pool.init(state)
        cohort.members[tid] = pool
        w = int(weight if weight is not None
                else (qos.weight if qos is not None else 1))
        handle = TenantHandle(tenant_id=tid, pool=pool, cohort=cohort,
                              qos=qos, weight=w)
        self._tenants[tid] = handle
        self.scheduler.register(tid, pool, weight=w)
        self._clock += 1
        handle.last_used = self._clock
        self._m_admit.inc()
        self.metrics.gauge("group_tenants").set(len(self._tenants))
        self.tracer.emit("tenant_admit", tenant=str(tid),
                         cohort=cohort.name,
                         qos=qos.name if qos is not None else None)
        return handle

    def evict(self, tid: str) -> PyTree:
        """Remove a tenant, flushing its open window first; returns its
        final (redundancy-current) global state for the caller to keep."""
        handle = self._tenants.pop(tid)
        handle.pool.flush()                    # flush-before-evict
        state = handle.pool.state
        handle.cohort.leave(tid)
        self.scheduler.unregister(tid)
        self._quarantined.discard(tid)
        self._m_evict.inc()
        self.metrics.gauge("group_tenants").set(len(self._tenants))
        self.tracer.emit("tenant_evict", tenant=str(tid))
        return state

    # -- commit -------------------------------------------------------------

    def commit(self, updates: Dict[str, PyTree], *, canary_ok=True,
               data_cursor=0, rng_keys=None, batched: bool = True,
               verify_old: bool = False) -> dict:
        """Commit a wave of per-tenant global updates; returns {tid:
        verdict}.

        Each cohort's batchable members commit in one batched wave (sync or
        deferred by the cohort's window); the rest loop through their own
        `pool.commit`, with the same verdicts and bytes (`batched=False`
        forces the loop: the baseline).  `canary_ok` is a bool or a {tid:
        bool} dict; a quarantined tenant's update is rejected with a host
        `False`."""
        self._clock += 1
        rng_keys = rng_keys or {}
        out: dict = {}

        def canary(tid):
            return (canary_ok.get(tid, True)
                    if isinstance(canary_ok, dict) else canary_ok)

        for tid in updates:
            if tid not in self._tenants:
                raise KeyError(f"unknown tenant {tid!r}")
            if tid in self._quarantined:
                out[tid] = False
                self._m_rejected.inc()
            else:
                self._tenants[tid].last_used = self._clock
        for cohort in self._cohorts.values():
            items, loop = [], []
            for tid, pool in cohort.members.items():
                if tid not in updates or tid in self._quarantined:
                    continue
                it = (tid, updates[tid], canary(tid), data_cursor,
                      rng_keys.get(tid))
                if batched and cohort.batchable(pool):
                    items.append(it)
                else:
                    loop.append(it)
            if len(items) == 1:
                loop += items
                items = []
            if items:
                self._m_batches.inc()
                if cohort.config.window > 1:
                    out.update(cohort.commit_deferred(items))
                else:
                    out.update(cohort.commit_sync(items,
                                                  verify_old=verify_old))
            for tid, state_new, can, dc, rk in loop:
                pool = cohort.members[tid]
                # verify_old is a synchronous-engine feature
                vkw = ({"verify_old": verify_old}
                       if pool.engine is None else {})
                out[tid] = pool.commit(state_new, canary_ok=can,
                                       data_cursor=dc, rng_key=rk, **vkw)
        return out

    def commit_async(self, updates: Dict[str, PyTree], *,
                     extras: Optional[dict] = None, **kw) -> CommitTicket:
        """Send a commit wave through the group's ring: one `CommitTicket`
        a wave, whose verdict is the AND of every tenant's
        (`ops.stage_verdict`) and whose `extras["verdicts"]` holds the
        per-tenant verdicts.  Up to `pipeline_depth` waves stay in flight;
        `drain()` is the boundary.  The tenants' protected states are
        updated at dispatch, so tenant operations never race a wave."""
        t0 = time.perf_counter()
        verdicts = self.commit(updates, **kw)
        ok = kops.stage_verdict(list(verdicts.values()), device=self.device)
        seq = self._ticket_seq
        self._ticket_seq += 1
        span = self.tracer.emit("wave_dispatch", seq=seq,
                                tenants=len(verdicts))
        ex = {"verdicts": verdicts}
        if extras:
            ex.update(extras)
        return self._ring.submit(CommitTicket(
            seq, ok, dispatched_at=t0, span_id=span, extras=ex,
            on_resolve=self._on_wave_resolved))

    def _on_wave_resolved(self, ticket: CommitTicket) -> None:
        self.metrics.histogram("group_wave_resolve_ms").observe(
            ticket.resolve_latency_ms, exemplar=ticket.span_id)

    def poll(self) -> list:
        """Resolve the waves whose verdicts already landed."""
        return self._ring.poll()

    def drain(self) -> list:
        """Resolve every in-flight wave, in dispatch order."""
        return self._ring.drain()

    # -- scrub / recover ----------------------------------------------------

    def scrub_tick(self, page_budget: Optional[int] = None) -> list:
        """One shared-scheduler pass: serve scrub and pre-check pressure by
        QoS-weighted commit age under the global page budget."""
        return self.scheduler.tick(page_budget)

    def recover(self, tid: str, fault: Fault, **kw):
        """Quarantined recovery: only the faulted tenant stops taking
        commits.  Re-raises the tenant's recovery error (budget exhausted)
        with the tenant left quarantined; lifts the quarantine on
        success."""
        handle = self._tenants[tid]
        self._quarantined.add(tid)
        self.scheduler.set_quarantined(tid, True)
        self.metrics.counter("group_quarantines_total").inc()
        self.tracer.emit("tenant_quarantine", tenant=str(tid),
                         fault_kind=fault.kind)
        rep = handle.pool.recover(fault, **kw)
        self._quarantined.discard(tid)
        self.scheduler.set_quarantined(tid, False)
        self.tracer.emit("tenant_unquarantine", tenant=str(tid))
        return rep

    def release(self, tid: str) -> None:
        """Lift a quarantine by hand (after an out-of-band repair, e.g. a
        `handle.pool.init` re-arm after a budget exhaust)."""
        self._quarantined.discard(tid)
        self.scheduler.set_quarantined(tid, False)

    def rescale(self, new_mesh) -> "PoolGroup":
        """Move every tenant to `new_mesh`; returns the new group.  Tenants
        are admitted cold into fresh cohorts built for the new zone
        geometry, and each pool moves through `Pool.rescale` (flush,
        bit-exact reshard, protection rebuilt).  The metrics and the trace
        are shared, so tenant labels survive the move."""
        self.drain()                   # waves never survive a rescale
        new = PoolGroup(
            new_mesh, capacity=self.capacity,
            evict_on_full=self.evict_on_full,
            scrub_page_budget=self.scheduler.page_budget,
            full_scrub_every=self.scheduler.full_every,
            pipeline_depth=self.pipeline_depth, device=self.device,
            metrics=self.metrics, tracer=self.tracer)
        for tid, handle in self._tenants.items():
            cold = new.admit(tid, handle.pool.abstract_state,
                             handle.pool.state_specs,
                             config=handle.pool.config, qos=handle.qos,
                             weight=handle.weight)
            handle.pool.rescale(new_mesh, into=cold.pool)
        return new

    # -- telemetry ----------------------------------------------------------

    def stats(self) -> dict:
        return {
            "tenants": len(self._tenants),
            "cohorts": {c.name: sorted(c.members)
                        for c in self._cohorts.values()},
            "quarantined": sorted(self._quarantined),
            "scheduler": self.scheduler.stats(),
            "per_tenant": {tid: h.pool.stats()
                           for tid, h in self._tenants.items()},
        }

    def health(self) -> dict:
        """Worst-of over the tenants' health, plus each tenant's report: a
        group is as healthy as its sickest tenant, and a quarantined tenant
        is at least degraded."""
        rank = {obs_health.GREEN: 0, obs_health.DEGRADED: 1,
                obs_health.CRITICAL: 2}
        per = {tid: h.pool.health() for tid, h in self._tenants.items()}
        worst = obs_health.GREEN
        for tid, rep in per.items():
            status = rep.status
            if tid in self._quarantined and rank[status] < 1:
                status = obs_health.DEGRADED
            if rank[status] > rank[worst]:
                worst = status
        return {"status": worst, "per_tenant": per,
                "quarantined": sorted(self._quarantined)}
