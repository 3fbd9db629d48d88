"""`Pool` — the Pangolin-style front door to the protection stack.

The synchronous half of the reference's facade (pool.py): one object that
owns the `Protector`, the `Scrubber` and every recovery path, so callers
never touch that plumbing directly.

    ================  =============================================
    Pangolin          this library
    ================  =============================================
    pgl_open          Pool.open(state, specs, mesh=..., config=...)
    pgl_begin/commit  with pool.transaction() as tx: tx.stage(new)
                      (or pool.commit(new, ...) directly)
    pgl_tx_abort      canary mismatch / exception inside the context
    scrubbing thread  pool.maybe_scrub() on the commit cadence
                      (pool.scrub() forces one)
    SIGBUS handler    pool.recover(Fault.rank_loss(r))
    corruption repair pool.recover(Fault.scribble(rank, pages))
    (beyond paper)    pool.recover(Fault.multi_loss(*ranks)) — any
                      e <= r simultaneous rank losses, rebuilt online
                      from the GF(2^32) syndrome stack
                      (ProtectConfig(redundancy=r))
    pool resize       pool.rescale(new_mesh)
    ================  =============================================

Callers hand the pool *global* tensors with their partition specs; the
pool holds them zone-stacked on one device (dist/sharding.py), and
`pool.state` gives the global view back.  The pool runs on `cuda` unless
the caller passes `device="cpu"`; with no GPU present, the default raises.
The pool holds the tensors it is given: stage a new tensor, do not
mutate a staged one in place.

With `ProtectConfig(window=W > 1)` the pool runs the deferred-epoch
engine (core/epoch.py): the bulk engine by default, the patch engine when
`dirty_leaf_idx` names the leaves commits touch.  Redundancy is refreshed
every W commits, and before every scrub, pre-check and recovery.
Transactions that declare disjoint page footprints
(`pool.transaction(pages=...)`) coalesce into one window; overlapping ones
serialize behind a flush.

`pool.commit_async(...)` enqueues a commit and returns a `CommitTicket`
(core/pipeline.py) without waiting for the device; up to
`ProtectConfig.pipeline_depth` tickets stay in flight, and `poll`, `drain`
or `ticket.result()` resolve them.  A canary checked on the device
(`tx.canary_device()`) rides into the commit as a staged verdict.  Flush,
scrub, pre-check and recovery drain the ring first.  Many same-shape pools
batch their commits through `repro_torch.tenancy.PoolGroup`.

`pool.rescale(new_mesh)` moves the pool to another zone geometry (flush,
bit-exact reshard, protection rebuilt at the new G).  With
`ProtectConfig(straggler_threshold > 0)` (or a `straggler_policy=`),
`observe_commit_times` feeds per-rank durations to the straggler policy;
while a rank is dropped the deferred window stays collapsed at 1.  The
chaos harness (repro_torch/chaos) corrupts a live pool through `inject`
or an arrival hook (`set_arrival_hook`); every fault it notes is linked
in the trace to the recovery or repairing scrub that resolves it.

A state given as `device="meta"` tensors (`utils.abstract`) opens a *cold*
pool: the layout exists, `pool.init(state)` attaches real state.

A mesh split over processes (`ZoneMesh(..., group=)`, dist/procs.py) opens
one pool a process: each calls the same methods with the same global
arguments (`canary_ok`, `dirty_words`, `observe_commit_times`' durations
included), holds its block of data ranks, and sees the one-process pool's
verdicts, reports and (gathered) `state`.  It runs both engines and the
async ring; a staged canary is agreed across the processes before the
commit selects on it.  The host cadence — the window, its boundary flush
and the scrub cadence — reads only values every process holds alike (the
global arguments, agreed verdicts and scrub reports), so no process
flushes or scrubs alone.  A split commit waits for its exchanges, so a
dispatch blocks and every ticket has landed when `commit_async` returns:
`poll` resolves the same tickets on every process.

A split pool also reads and writes its process's block alone, as tensors
on `mesh.block_mesh` (dist/sharding.py): `pool.block_state` (no
exchange) and `commit(..., block=True)` / `commit_async(..., block=True)`,
which take the block view of the new state.
That is how a server or a trainer split over processes drives its pool
without gathering the whole state a step.  `rescale` moves a split pool
to a mesh split over the same group (the state gathered and resharded)
or over another subgroup of its world (`sharding.split_mesh`), which
changes the process count: only the rows that change owner move, a
process that was a spare of the old mesh takes part through `Pool.join`,
and one that leaves gets None.  A move between a one-process zone and a
split one is refused.  A multi-rank loss over the syndrome budget is
refused on every process or on none (the verdict is agreed).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import utils
from repro_torch.configs.base import ProtectConfig
from repro_torch.core import microbuffer
from repro_torch.core import recovery as recovery_mod
from repro_torch.core.epoch import DeferredProtector, EngineHost
from repro_torch.core.pipeline import CommitRing, CommitTicket
from repro_torch.core.scrub import ScrubReport, Scrubber
from repro_torch.core.txn import (Mode, ProtectedState, Protector,
                                  device_bool, tree_select)
from repro_torch.dist import elastic, procs, sharding
from repro_torch.dist.straggler import StragglerPolicy
from repro_torch.kernels import ops as kops
from repro_torch.obs import health as obs_health
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer, layer

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Fault:
    """One recovery request — the argument to `Pool.recover`.

        Fault.rank_loss(r)          one data-rank's row lost (media error)
        Fault.scribble(rank, pages) silent corruption at (rank, page)s
        Fault.multi_loss(*ranks)    e ranks lost at once (needs
                                    redundancy >= e syndromes)
        Fault.double_loss(a, b)     the e = 2 alias
        Fault.from_event(event)     adapt a runtime FailureEvent
    """
    kind: str                                   # rank_loss | multi_loss
                                                # | scribble
    rank: Optional[int] = None
    ranks: Optional[Tuple[int, ...]] = None
    locations: Optional[Tuple[Tuple[int, int], ...]] = None

    @staticmethod
    def rank_loss(rank: int) -> "Fault":
        return Fault("rank_loss", rank=int(rank))

    @staticmethod
    def multi_loss(*ranks: int) -> "Fault":
        dead = tuple(sorted(int(r) for r in ranks))
        if len(set(dead)) != len(dead) or len(dead) < 2:
            raise ValueError(
                f"multi loss needs >= 2 distinct ranks, got {ranks}")
        return Fault("multi_loss", ranks=dead)

    @staticmethod
    def double_loss(a: int, b: int) -> "Fault":
        return Fault.multi_loss(a, b)

    @staticmethod
    def scribble(rank: int, pages: Sequence[int]) -> "Fault":
        return Fault("scribble",
                     locations=tuple((int(rank), int(p)) for p in pages))

    @classmethod
    def from_event(cls, event) -> "Fault":
        """Adapt a runtime/failure.py FailureEvent (duck-typed)."""
        if event.kind == "rank_loss":
            return cls.rank_loss(event.lost_rank)
        if event.kind in ("multi_loss", "double_loss"):
            return cls.multi_loss(*event.lost_ranks)
        if event.kind == "scribble":
            return cls("scribble",
                       locations=tuple((int(r), int(p))
                                       for r, p in event.locations))
        raise ValueError(f"no recovery path for fault kind {event.kind!r}")


class Transaction:
    """`pgl_tx_begin .. pgl_tx_commit` as a context manager.

    Stage the update with `stage(new_state)` (global tensors); register
    canary-guarded staging buffers with `watch(...)`.  On exit the
    canaries are verified and the staged state commits through the pool —
    a smashed canary (or `abort()`) aborts without touching protected
    state.  An exception inside the block also aborts and propagates.
    """

    def __init__(self, pool: "Pool", *, data_cursor=0, rng_key=None,
                 pages: Optional[Sequence[int]] = None):
        self._pool = pool
        self._data_cursor = data_cursor
        self._rng_key = rng_key
        # the page footprint declared at pool.transaction(pages=...), the
        # merged-window conflict check's currency (None = whole state)
        self.pages = (None if pages is None
                      else tuple(int(p) for p in pages))
        self._staged: Optional[PyTree] = None
        self._commit_kw: dict = {}
        self._guarded: list = []          # (buffer, nd) pairs
        self._aborted = False
        self._ok: Optional[torch.Tensor] = None

    def stage(self, new_state: PyTree, *, dirty_pages=None,
              dirty_words=None, verify_old: bool = False) -> None:
        """Stage the transaction's result (the micro-buffer contents)."""
        self._staged = new_state
        self._commit_kw = {"dirty_pages": dirty_pages,
                           "dirty_words": dirty_words,
                           "verify_old": verify_old}

    def watch(self, guarded: torch.Tensor, *, nd: bool = False
              ) -> torch.Tensor:
        """Register a canary-guarded staging buffer for verification at
        commit; returns the buffer unchanged for chaining."""
        self._guarded.append((guarded, nd))
        return guarded

    def guard(self, row: torch.Tensor) -> torch.Tensor:
        """Append a canary page to a 1-D int32 staging buffer and watch it."""
        return self.watch(microbuffer.guard(row))

    def abort(self) -> None:
        """Abort explicitly: nothing commits when the block exits."""
        self._aborted = True

    @property
    def canary_ok(self) -> bool:
        """Host verdict over every watched guard page (True if none)."""
        return all(bool(c) for c in self._checks())

    def _checks(self) -> list:
        return [microbuffer.check_nd(b) if nd else microbuffer.check(b)
                for b, nd in self._guarded]

    def canary_device(self) -> torch.Tensor:
        """The verdict over every watched guard page as one unread 0-d
        device bool (`ops.stage_verdict`): the staged canary of
        `pool.commit_async(canary_ok=tx.canary_device())`, whose abort
        select rides in the commit, so the dispatch never reads it the way
        `canary_ok` does."""
        return kops.stage_verdict(self._checks(), device=self._pool.device)

    @property
    def aborted(self) -> bool:
        return self._aborted

    @property
    def ok(self) -> bool:
        """Did the commit land?  (Syncs on the commit's verdict.)"""
        if self._aborted or self._ok is None:
            return False
        return bool(self._ok)

    @property
    def committed(self) -> bool:
        """Alias of `ok` — True only when the commit actually landed,
        including verdicts reached on the device (a verify-at-open
        mismatch aborts after the host canary passed)."""
        return self.ok

    def __enter__(self) -> "Transaction":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self._aborted = True          # exception == pgl_tx_abort
            return False                  # propagate
        if self._staged is None:
            return False                  # nothing staged: a no-op tx
        canary_ok = (not self._aborted) and self.canary_ok
        group = self._pool.mesh.group
        if group is not None:
            # one process's smashed canary aborts the zone's transaction
            canary_ok = group.agree(canary_ok)
        self._ok = self._pool.commit(
            self._staged, data_cursor=self._data_cursor,
            rng_key=self._rng_key, canary_ok=canary_ok, **self._commit_kw)
        if not canary_ok:
            self._aborted = True
        return False


class Pool(EngineHost):
    """The single public entry point over one protected state layout.

    `config.window > 1` builds the deferred engine; `dirty_leaf_idx` (leaf
    indices, or a callable of the zone layout) makes it a patch engine,
    with `dirty_capacity` pages a commit at most.  `replicate_meta`
    mirrors the window's metadata every commit (default: on for a bulk
    engine, off for a patch engine, as in the reference).  `donate` is
    accepted for the reference's signature and changes nothing: the port
    builds every successor functionally.  `protector` hands in a Protector
    built for this mesh, mode and redundancy, to share with other pools of
    the same shape (a tenancy cohort).  `straggler_policy` replaces the
    policy that `config.straggler_threshold > 0` builds.
    """

    def __init__(self, mesh: sharding.ZoneMesh, abstract_state: PyTree,
                 state_specs: PyTree,
                 config: Optional[ProtectConfig] = None, *,
                 device=None,
                 dirty_leaf_idx=None,
                 dirty_capacity=None,
                 donate: bool = True,
                 replicate_meta: Optional[bool] = None,
                 on_freeze: Optional[Callable] = None,
                 on_resume: Optional[Callable] = None,
                 straggler_policy: Optional[StragglerPolicy] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 protector: Optional[Protector] = None):
        if mesh.is_spare:
            raise procs.SpareError(
                f"a pool on {mesh!r}: this process is a spare of the mesh "
                "and holds no block (Pool.join takes part in a rescale "
                "onto a mesh it is a member of)")
        self.config = config if config is not None else ProtectConfig()
        self.device = utils.resolve_device(device)
        self.mesh = mesh
        # the global shapes and dtypes, all that a rescale rebuilds from
        self.abstract_state = utils.abstract(abstract_state)
        self.state_specs = state_specs
        self._spec_leaves = utils.tree_leaves(state_specs)
        self.on_freeze = on_freeze
        self.on_resume = on_resume
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        # what a rescale opens the new pool with: the metrics and the tracer
        # carry over (one campaign, one namespace and one trace), and the
        # footprint arguments stay unresolved, so that a callable is
        # resolved again against the new mesh's layout
        self._open_kw = dict(device=self.device,
                             dirty_leaf_idx=dirty_leaf_idx,
                             dirty_capacity=dirty_capacity, donate=donate,
                             replicate_meta=replicate_meta,
                             straggler_policy=straggler_policy,
                             metrics=self.metrics, tracer=self.tracer)
        if protector is None:
            protector = protector_for(mesh, abstract_state, state_specs,
                                      self.config)
        elif (protector.mesh is not mesh
              or protector.mode is not self.config.resolved_mode
              or protector.redundancy != self.config.resolved_redundancy):
            raise ValueError("a shared protector must be built on this "
                             "pool's mesh, with its config's mode and "
                             "redundancy")
        self.protector = protector
        if callable(dirty_leaf_idx):
            dirty_leaf_idx = dirty_leaf_idx(self.protector.layout)
        if callable(dirty_capacity):
            dirty_capacity = dirty_capacity(self.protector.layout)
        self._engine: Optional[DeferredProtector] = None
        self._est = None
        self._prot: Optional[ProtectedState] = None
        if self.config.window > 1:
            # ProtectConfig guarantees a parity or checksum mode here
            if replicate_meta is None:
                replicate_meta = dirty_leaf_idx is None
            self._engine = DeferredProtector(
                self.protector, window=self.config.window,
                dirty_capacity=dirty_capacity,
                dirty_leaf_idx=dirty_leaf_idx,
                replicate_meta=replicate_meta)
            self._engine.metrics = self.metrics
        self.scrubber = Scrubber(
            self.protector, period=self.config.scrub_period,
            engine=self._engine,
            growth_commits=self.config.window_growth_commits)
        self.scrubber.metrics = self.metrics
        self._due_scrubs = 0          # full_scrub_every cadence counter
        r_armed = self.redundancy if self.mode.has_parity else 0
        self.metrics.gauge("pool_window").set(
            self._engine.window if self._engine is not None else 1)
        self.metrics.gauge("pool_redundancy").set(r_armed)
        self.metrics.gauge("pool_budget_remaining").set(r_armed)
        self._m_commits = self.metrics.counter("pool_commits_total")
        self._m_aborted = self.metrics.counter("pool_commit_aborted_total")
        self._m_commit_ms = self.metrics.histogram("pool_commit_dispatch_ms")
        # the async commit ring behind commit_async; a resolve latency
        # carries its dispatch span id as the histogram exemplar
        self._m_resolve_ms = self.metrics.histogram("pool_commit_resolve_ms")
        self._m_inflight = self.metrics.gauge("pool_inflight_depth")
        self._ring = CommitRing(self.config.pipeline_depth,
                                on_depth=self._m_inflight.set)
        self._ticket_seq = 0
        # merged-window bookkeeping: the page-footprint union of every
        # transaction opened since the last flush; a conflicting footprint
        # seals the group (flush) before the new transaction joins a fresh
        # one, so conflicting transactions serialize and disjoint ones
        # coalesce into one telescoped flush
        self._merge_open = False
        self._merge_all = False
        self._merge_pages: set = set()
        self._m_txn_serialized = self.metrics.counter(
            "pool_txn_serialized_total")
        self._m_txn_coalesced = self.metrics.counter(
            "pool_txn_coalesced_total")
        # health bookkeeping (host flags; pool.health() folds these)
        self._n_recoveries = 0
        self._n_followups = 0
        self._suspect = False
        self._budget_exhausted = False
        self._last_reverify_ok: Optional[bool] = None
        self._unrepaired_pages = 0
        # fault ids noted (note_fault / inject) and not yet consumed by the
        # recovery or repairing scrub span that resolves them: the trace
        # linkage that obs.validate_events checks
        self._open_fault_ids: list = []
        # straggler mitigation: while any replica is dropped the pool runs
        # degraded, its deferred window held at 1
        self.straggler: Optional[StragglerPolicy] = straggler_policy
        if self.straggler is None and self.config.straggler_threshold > 0:
            self.straggler = StragglerPolicy(
                self.protector.group_size,
                threshold=self.config.straggler_threshold)
        self._dropped: set = set()
        # faults arriving while a recovery is in flight (from freeze /
        # resume callbacks, chaos hooks) queue here and drain after it
        self._recovering = False
        self._pending_faults: list = []
        # the commit loop's fault-arrival hook (set_arrival_hook); a tenancy
        # cohort batches only pools without one
        self._arrival_fn: Optional[Callable] = None

    # -- open -------------------------------------------------------------------

    @classmethod
    def open(cls, state: PyTree, specs: PyTree, *, mesh: sharding.ZoneMesh,
             config: Optional[ProtectConfig] = None, **kw) -> "Pool":
        """The `pgl_open` analogue: protect `state` (global tensors or
        numpy arrays, one spec each) and return the pool.  A state of
        `device="meta"` tensors opens a cold pool: call `pool.init(state)`
        to attach real state."""
        state = utils.tree_map(torch.as_tensor, state)
        pool = cls(mesh, state, specs, config, **kw)
        return pool if utils.is_abstract(state) else pool.init(state)

    def init(self, state: PyTree, *, block: bool = False) -> "Pool":
        """Build parity/checksums/row for global `state` (with `block`,
        this process's block view of it; fresh protection).  Also the
        re-arm point after a budget-exhausted storm: it clears the health
        flags and restores the full syndrome budget.  Commits still in
        flight are superseded: their tickets are voided (verdict False,
        the device not consulted)."""
        self._ring.void_all()
        self.prot = self.protector.init(self.to_zone(state, block=block))
        self._budget_exhausted = False
        self._unrepaired_pages = 0
        self._last_reverify_ok = None
        self._suspect = False
        self.metrics.gauge("pool_budget_remaining").set(
            self.redundancy if self.mode.has_parity else 0)
        return self

    def to_zone(self, state: PyTree, *, block: bool = False) -> PyTree:
        """Global tensors (with `block`, this process's block view) ->
        zone-stacked leaves on the pool's device."""
        leaves, treedef = utils.tree_flatten(state)
        if len(leaves) != len(self._spec_leaves):
            raise ValueError(f"{len(leaves)} leaves for "
                             f"{len(self._spec_leaves)} specs")
        mesh = self.mesh.block_mesh if block else self.mesh
        out = [sharding.shard(torch.as_tensor(x).to(self.device), spec, mesh)
               for x, spec in zip(leaves, self._spec_leaves)]
        return utils.tree_unflatten(treedef, out)

    # -- introspection ----------------------------------------------------------

    @property
    def mode(self) -> Mode:
        return self.protector.mode

    @property
    def redundancy(self) -> int:
        return self.protector.redundancy

    @property
    def engine(self) -> Optional[DeferredProtector]:
        """The deferred-epoch engine, or None on the synchronous cadence."""
        return self._engine

    @property
    def state(self) -> Optional[PyTree]:
        """The live protected state as global tensors (along replicated
        axes, the copy at mesh coordinate 0); on a split zone gathered
        from every process (each must read it)."""
        if self.prot is None:
            return None
        return self.global_view(self.prot.state)

    @property
    def block_state(self) -> Optional[PyTree]:
        """The live protected state as this process's block view (tensors
        on `mesh.block_mesh`; no exchange): the global state on one
        process."""
        if self.prot is None:
            return None
        leaves, treedef = utils.tree_flatten(self.prot.state)
        return utils.tree_unflatten(treedef, [
            sharding.block_view(x, spec, self.mesh)
            for x, spec in zip(leaves, self._spec_leaves)])

    def global_view(self, zone_state: PyTree) -> PyTree:
        """Zone-stacked leaves of this pool's layout -> global tensors."""
        leaves, treedef = utils.tree_flatten(zone_state)
        return utils.tree_unflatten(treedef, [
            sharding.unshard(x, spec, self.mesh)
            for x, spec in zip(leaves, self._spec_leaves)])

    @property
    def step(self) -> int:
        """Committed transaction count (host value)."""
        return int(self.prot.step) & 0xFFFFFFFF

    def overhead_report(self) -> dict:
        rep = self.protector.overhead_report()
        rep["window"] = (self._engine.window if self._engine is not None
                         else 1)
        return rep

    def stats(self) -> dict:
        """One host-side snapshot of the pool's telemetry (no device sync)."""
        eng = self._engine
        return {
            "mode": self.mode.value,
            "redundancy": self.redundancy,
            "engine": "deferred" if eng is not None else "sync",
            "window": eng.window if eng is not None else 1,
            "max_window": eng.max_window if eng is not None else 1,
            "commits": int(self._m_commits.value),
            "aborted_commits": int(self._m_aborted.value),
            "commit_dispatch_ms": self._m_commit_ms.summary(),
            "pipeline_depth": self.config.pipeline_depth,
            "in_flight": len(self._ring),
            "commit_resolve_ms": self._m_resolve_ms.summary(),
            "scrub": self.scrubber.coverage(),
            "recoveries": self._n_recoveries,
            "recovery_followups": self._n_followups,
            "dropped_replicas": self.dropped_replicas,
            "suspect": self._suspect,
            "budget_exhausted": self._budget_exhausted,
            "metrics": self.metrics.snapshot(),
        }

    def health(self) -> obs_health.HealthReport:
        """Green / degraded / critical with named reasons (host state)."""
        eng = self._engine
        return obs_health.assess(
            window=eng.window if eng is not None else 1,
            max_window=eng.max_window if eng is not None else 1,
            dropped_replicas=self._dropped,
            suspect=self._suspect,
            redundancy=self.redundancy if self.mode.has_parity else 0,
            budget_exhausted=self._budget_exhausted,
            scrub_coverage=self.scrubber.coverage(),
            unrepaired_pages=self._unrepaired_pages,
            reverify_failed=self._last_reverify_ok is False,
            recoveries=self._n_recoveries,
            recovery_followups=self._n_followups)

    def commit_program(self, *, dirty_pages=None, verify_old: bool = False):
        """The synchronous-commit function the facade routes through."""
        return self.protector.commit_program(dirty_pages=dirty_pages,
                                             verify_old=verify_old)

    # -- commit -----------------------------------------------------------------

    def commit(self, state_new: PyTree, *, dirty_pages=None,
               dirty_words=None, data_cursor=0, rng_key=None,
               canary_ok: bool = True, verify_old: bool = False,
               block: bool = False) -> torch.Tensor:
        """One transactional update of global `state_new` (with `block`,
        this process's block view of it); returns the verdict as a 0-d
        bool tensor (read it to sync).

        The deferred engine takes `dirty_words` (per-leaf word indices of
        its `dirty_leaf_idx` leaves) and ignores `dirty_pages`; the
        synchronous engine takes `dirty_pages` and ignores `dirty_words`.
        `verify_old` is a synchronous-engine feature."""
        with layer("pool.commit"):
            t0 = time.perf_counter()
            canary_ok = bool(canary_ok)
            ok = self._enqueue(state_new, dirty_pages, dirty_words,
                               data_cursor, rng_key, canary_ok, verify_old,
                               block)
            self._note_commit(canary_ok, (time.perf_counter() - t0) * 1e3)
            return ok

    def _note_commit(self, canary_ok: Optional[bool], ms: float) -> None:
        """A commit's host bookkeeping: the count, the dispatch ms and, when
        the canary verdict is known on the host (None: a staged canary, not
        read yet), the verdict's."""
        if canary_ok is not None:
            self._note_verdict(canary_ok)
        self._m_commits.inc()
        self._m_commit_ms.observe(ms)

    def _note_verdict(self, clean: bool) -> None:
        """The scrub cadence and the clean-streak window growth ride on the
        canary verdict; an abort is counted."""
        self.scrubber.on_commit(clean=clean)
        if not clean:
            self._m_aborted.inc()

    def _enqueue(self, state_new, dirty_pages, dirty_words, data_cursor,
                 rng_key, canary_ok, verify_old, block) -> torch.Tensor:
        """Enqueue one commit on the engine; returns its device verdict.
        `canary_ok` is a host bool, or a 0-d device bool (staged)."""
        if self.prot is None:
            raise RuntimeError("Pool.commit before init()")
        with layer("pool.to_zone"):
            zone = self.to_zone(state_new, block=block)
        staged = isinstance(canary_ok, torch.Tensor)
        if self._engine is not None:
            if verify_old:
                raise ValueError("verify_old is a synchronous-engine "
                                 "feature (window=1)")
            if staged:
                self._est, ok = self._engine.commit_staged(
                    self._est, zone, canary=canary_ok,
                    dirty_words=dirty_words, data_cursor=data_cursor,
                    rng_key=rng_key)
            else:
                self._est, ok = self._engine.commit(
                    self._est, zone, dirty_words=dirty_words,
                    data_cursor=data_cursor, rng_key=rng_key,
                    canary_ok=canary_ok)
            return ok
        program = self.commit_program(dirty_pages=dirty_pages,
                                      verify_old=verify_old)
        if not staged:
            self._prot, ok = program(self._prot, zone,
                                     data_cursor=data_cursor,
                                     rng_key=rng_key, canary_ok=canary_ok)
        else:
            # the all-clear commit, then the whole protected state selected
            # on the canary: a False canary leaves the old state, the redo
            # log included.  (A host-known abort appends its record
            # unmarked; the reference's staged abort does not, and the port
            # keeps both.)  A split zone selects on the agreed canary.
            prot_new, ok_c = program(self._prot, zone,
                                     data_cursor=data_cursor,
                                     rng_key=rng_key, canary_ok=True)
            v = device_bool(canary_ok, ok_c.device)
            if self.mesh.group is not None:
                v = self.mesh.group.all_and(v)
            self._prot = tree_select(v, prot_new, self._prot)
            ok = v & ok_c
        if self._arrival_fn is not None:
            # synchronous cadence: every commit is its own window boundary,
            # so the arrival point is right after it
            new = self._arrival_fn(self._prot, 1, True)
            if new is not None:
                self._prot = new
        return ok

    # -- async commit ring ------------------------------------------------------

    def commit_async(self, state_new: PyTree, *, dirty_pages=None,
                     dirty_words=None, data_cursor=0, rng_key=None,
                     canary_ok=True, verify_old: bool = False,
                     extras: Optional[dict] = None,
                     block: bool = False) -> CommitTicket:
        """One transactional update as a future: enqueues the commit and
        returns a `CommitTicket` over its unread device verdict.  Up to
        `pipeline_depth` tickets stay in flight (past that the oldest is
        resolved first); they resolve through `ticket.result()`,
        `pool.poll()` (out of dispatch order) or `pool.drain()`.

        `canary_ok` is a host bool, as `commit` takes, or an unread 0-d
        device bool (`tx.canary_device()`, `ops.stage_verdict`): the
        staged form, whose abort select rides in the commit and whose
        abort bookkeeping (abort counter, scrub clean streak) waits for
        resolution.  Routing and `block` match `commit`.

        On a split zone the dispatch blocks: the commit's exchanges
        synchronize the stream, and the stream is synchronized once more
        at its end, so the ticket has landed on every process at once and
        `poll` resolves the same tickets on each with no exchange (the
        staged bookkeeping at resolution then stays in step)."""
        with layer("pool.commit"):
            t0 = time.perf_counter()
            staged = isinstance(canary_ok, torch.Tensor)
            if not staged:
                canary_ok = bool(canary_ok)
            ok = self._enqueue(state_new, dirty_pages, dirty_words,
                               data_cursor, rng_key, canary_ok, verify_old,
                               block)
            split = self.mesh.group is not None
            if split and ok.is_cuda:
                torch.cuda.current_stream(ok.device).synchronize()
            seq = self._ticket_seq
            self._ticket_seq += 1
            span_id = self.tracer.emit("commit_dispatch", seq=seq,
                                       staged=staged)
            self._note_commit(None if staged else canary_ok,
                              (time.perf_counter() - t0) * 1e3)
            return self._ring.submit(CommitTicket(
                seq, ok, dispatched_at=t0, span_id=span_id, extras=extras,
                staged=staged, landed=split,
                on_resolve=self._on_ticket_resolved))

    def _on_ticket_resolved(self, ticket: CommitTicket) -> None:
        """Fires once a ticket: the resolve latency (with its span id as
        the exemplar); a staged canary settles its abort bookkeeping now
        that the verdict is known on the host."""
        self._m_resolve_ms.observe(ticket.resolve_latency_ms,
                                   exemplar=ticket.span_id)
        if ticket.staged:
            self._note_verdict(bool(ticket.result()))

    def poll(self) -> list:
        """Resolve the in-flight tickets whose verdicts already landed (out
        of dispatch order); returns them."""
        return self._ring.poll()

    def drain(self) -> list:
        """Resolve every in-flight ticket, in dispatch order: the boundary
        that flush, scrub, pre-check and recovery take first."""
        return self._ring.drain()

    @property
    def in_flight(self) -> int:
        """Unresolved commit tickets in the ring."""
        return len(self._ring)

    def flush(self) -> None:
        """Resolve the commit ring, bring deferred redundancy current (no-op
        when synchronous) and close any open transaction merge group: a
        flush is the boundary every coalesced window telescopes into."""
        self.drain()
        super().flush()
        self._merge_open = False
        self._merge_all = False
        self._merge_pages = set()

    def _enter_footprint(self, pages) -> bool:
        """The page-granular conflict check at `transaction()` entry: a
        footprint disjoint from the open merge group joins it (its commits
        coalesce into the same window); a conflicting one (overlap, or
        either side whole-state) seals the group with a flush first, so
        conflicting transactions serialize across windows.  Returns True
        when this entry serialized."""
        whole = pages is None
        fp = set() if whole else set(int(p) for p in pages)
        if not self._merge_open:
            self._merge_open = True
            self._merge_all = whole
            self._merge_pages = fp
            return False
        if self._merge_all or whole or self._merge_pages & fp:
            self._m_txn_serialized.inc()
            self.flush()
            self._merge_open = True
            self._merge_all = whole
            self._merge_pages = fp
            return True
        self._m_txn_coalesced.inc()
        self._merge_pages |= fp
        return False

    def transaction(self, *, data_cursor=0, rng_key=None,
                    pages: Optional[Sequence[int]] = None) -> Transaction:
        """`pgl_tx_begin`: returns the staging context manager.  `pages`
        declares the transaction's page footprint: transactions with
        disjoint footprints coalesce into one deferred window; overlapping
        ones, or any that declares none (the whole state), serialize
        behind a flush."""
        self._enter_footprint(pages)
        return Transaction(self, data_cursor=data_cursor, rng_key=rng_key,
                           pages=pages)

    # -- fault arrival (chaos harness) -------------------------------------------

    def set_arrival_hook(self, fn: Optional[Callable]) -> None:
        """Register `fn(prot, since, at_boundary) -> Optional[ProtectedState]`
        at the commit loop's fault-arrival point.

        Deferred engine: the hook fires inside `commit`, after the
        in-window commit and before any boundary flush (the engine's
        `arrival_hook` point); a returned ProtectedState replaces the
        window's, modelling corruption landing concurrent with traffic.
        Synchronous engine: the hook fires right after each commit.  None
        clears it."""
        self._arrival_fn = fn
        if self._engine is not None:
            if fn is None:
                self._engine.arrival_hook = None
            else:
                def hook(est, since, at_boundary):
                    new = fn(est.prot, since, at_boundary)
                    return (None if new is None
                            else dataclasses.replace(est, prot=new))
                self._engine.arrival_hook = hook

    def note_fault(self, kind: str, **fields) -> int:
        """Record a fault's arrival in the telemetry plane; returns its
        trace id.  The id stays open until the next recovery (or repairing
        scrub) span consumes it into its `faults` list, the linkage
        `validate_events` checks.  `inject` notes its faults itself; a
        harness that corrupts state by other means (an arrival hook) calls
        this (or `note_event`)."""
        self.metrics.counter("pool_faults_total", kind=str(kind)).inc()
        fid = self.tracer.emit("fault", fault_kind=str(kind), **fields)
        self._open_fault_ids.append(fid)
        return fid

    def note_event(self, event) -> int:
        """`note_fault` from a FailureEvent (duck-typed)."""
        fields = {}
        if getattr(event, "lost_rank", None) is not None:
            fields["lost_rank"] = int(event.lost_rank)
        if getattr(event, "lost_ranks", None):
            fields["lost_ranks"] = [int(r) for r in event.lost_ranks]
        if getattr(event, "locations", None):
            fields["pages"] = [[int(r), int(p)] for r, p in event.locations]
        return self.note_fault(getattr(event, "kind", "inject"), **fields)

    def set_tracer(self, tracer: Tracer) -> None:
        """Swap the trace sink (e.g. for a file-backed tracer after the
        pool was built); a pool that `rescale` builds emits into it too."""
        self.tracer = tracer
        self._open_kw["tracer"] = tracer

    def inject(self, fn: Callable):
        """Apply a failure injector `fn(protector, prot) -> (prot, event)`
        to the live protected state in place, keeping an open window's
        bookkeeping (the `prot` setter would open a fresh window and drop
        the accumulator a later flush needs).  Returns the injector's
        FailureEvent, noted as a fault in the trace."""
        if self.prot is None:
            raise RuntimeError("Pool.inject before init()")
        new_prot, event = fn(self.protector, self.prot)
        if self._engine is not None:
            self._est = dataclasses.replace(self._est, prot=new_prot)
        else:
            self._prot = new_prot
        self.note_event(event)
        return event

    # -- straggler degradation ----------------------------------------------------

    @property
    def dropped_replicas(self) -> list:
        """Data ranks the straggler policy currently drops."""
        return sorted(self._dropped)

    def observe_commit_times(self, durations) -> np.ndarray:
        """Feed per-replica commit-loop durations (seconds, one a data
        rank) to the straggler policy; returns its participation mask.

        While any replica is dropped the deferred window is held at 1
        (every observation collapses it again, so clean-commit growth
        cannot outpace a live straggler) and the scrub clean streak
        resets; once the fleet is healthy the window regrows through the
        usual clean-scrub and clean-commit signals."""
        if self.straggler is None:
            raise RuntimeError(
                "no straggler policy on this pool: set "
                "ProtectConfig.straggler_threshold > 0 (or pass "
                "straggler_policy=) to enable mitigation")
        for rank, dur in enumerate(durations):
            self.straggler.observe(rank, float(dur))
        mask = self.straggler.replica_mask()
        before = self._dropped
        self._dropped = set(int(r) for r in np.flatnonzero(~mask))
        if self._dropped:
            if self._engine is not None:
                self._engine.report_pressure(True)
            self.scrubber.note_suspect()
        newly, healed = self._dropped - before, before - self._dropped
        if newly:
            self.metrics.counter("pool_straggler_drop_total").inc(len(newly))
            self.tracer.emit("straggler_drop", replicas=sorted(newly))
        if healed:
            self.metrics.counter("pool_straggler_heal_total").inc(len(healed))
        self.metrics.gauge("pool_dropped_replicas").set(len(self._dropped))
        return mask

    # -- scrub ------------------------------------------------------------------

    def scrub(self) -> ScrubReport:
        """Force one global scrub (flushing any open window first);
        repairs detected scribbles in place and feeds the adaptive
        window."""
        if self.prot is None:
            raise RuntimeError("Pool.scrub before init()")
        self.flush()                 # scrub must see current redundancy
        with self.tracer.span("scrub", scope="full") as span:
            self.prot, report = self.scrubber.run(
                self.prot, freeze=self._freeze, resume=self._resume)
            span.annotate(suspect=bool(report.suspect),
                          bad_pages=len(report.bad_locations),
                          repaired=bool(report.repaired))
            # a scrub whose repair fixed pages resolves the open fault ids,
            # linked here as a recovery span links them
            if report.repaired and self._open_fault_ids:
                fault_ids, self._open_fault_ids = self._open_fault_ids, []
                span.annotate(faults=fault_ids)
        self._fold_scrub_health(report)
        repaired_ok = report.repaired and bool(report.repair_ok)
        if report.bad_locations and not repaired_ok:
            self._unrepaired_pages = len(report.bad_locations)
        else:
            self._unrepaired_pages = 0
        return report

    def precheck(self) -> ScrubReport:
        """The rank-local syndrome scrub: state blocks vs checksums,
        row-cache coherence and the folded-syndrome compare."""
        if self.prot is None:
            raise RuntimeError("Pool.precheck before init()")
        self.flush()
        with self.tracer.span("scrub", scope="precheck") as span:
            report = self.scrubber.precheck(self.prot)
            span.annotate(suspect=bool(report.suspect))
        self._fold_scrub_health(report)
        return report

    def _fold_scrub_health(self, report: ScrubReport) -> None:
        """Suspicion follows the latest checked pass; a clean pass also
        retires a stale reverify-failed flag."""
        if not report.checked:
            return
        self._suspect = bool(report.suspect)
        if not report.suspect:
            self._last_reverify_ok = None

    def maybe_scrub(self) -> Optional[ScrubReport]:
        """Run a scrub iff the cadence says one is due.  With
        `full_scrub_every = N > 1` a due scrub first runs the pre-check;
        only every Nth due scrub, or a suspect pre-check, goes global."""
        if not self.scrubber.due():
            return None
        n = self.config.full_scrub_every
        self._due_scrubs += 1
        if n > 1 and self._due_scrubs % n:
            report = self.precheck()
            if not report.suspect:
                self.scrubber.mark_checked()
                return report
        return self.scrub()

    # -- recovery ---------------------------------------------------------------

    def recover(self, fault: Fault, *, reverify: bool = True
                ) -> Optional[recovery_mod.RecoveryReport]:
        """One recovery path for every fault (the SIGBUS-handler analogue).
        A `Fault.multi_loss` of e ranks solves online when e <= redundancy;
        e > r raises the budget-exhausted error (naming the dead ranks and
        the available r) and latches the health surface critical until
        `init` re-arms the pool.

        `reverify=True` re-runs the full syndrome/checksum verification
        after reconstruction (`report.synd_ok`, `report.reverified`).  A
        fault arriving while a recovery is in flight is queued and drained
        after it; that call returns None and the outer report counts it in
        `followups`.
        """
        if self.prot is None:
            raise RuntimeError("Pool.recover before init()")
        if not isinstance(fault, Fault):
            fault = Fault.from_event(fault)   # accept raw FailureEvents
        if self._recovering:
            self._pending_faults.append((fault, time.perf_counter()))
            self.metrics.counter("pool_recovery_queued_total").inc()
            return None
        self._recovering = True
        try:
            rep = self._recover_one(fault, reverify=reverify)
            drained = 0
            while self._pending_faults:
                qfault, t_enq = self._pending_faults.pop(0)
                self._recover_one(
                    qfault, reverify=reverify,
                    queue_wait_ms=(time.perf_counter() - t_enq) * 1e3)
                drained += 1
            rep.followups = drained
            self._n_followups += drained
            return rep
        finally:
            self._recovering = False
            self._pending_faults.clear()

    def _recover_one(self, fault: Fault, *, reverify: bool,
                     queue_wait_ms: Optional[float] = None
                     ) -> recovery_mod.RecoveryReport:
        t_total = time.perf_counter()
        # this recovery resolves every fault id noted since the last
        # resolving span (a drained follow-up takes the ids noted while the
        # outer recovery ran)
        fault_ids, self._open_fault_ids = self._open_fault_ids, []
        with self.tracer.span("recovery", fault_kind=fault.kind,
                              faults=fault_ids) as span:
            if fault.kind == "multi_loss":
                # refuse an over-budget solve up front, before anything is
                # touched, on every process of a split zone or on none
                over = self._over_budget(fault.ranks)
                if over is not None:
                    self._budget_exhausted = True
                    self.metrics.counter(
                        "pool_budget_exhausted_total").inc()
                    self.metrics.gauge("pool_budget_remaining").set(0)
                    raise over
            # the survivors' copy of the window metadata, captured before
            # the flush changes the window
            meta = (self._engine.window_meta
                    if self._engine is not None else None)
            self.flush()
            if fault.kind == "rank_loss":
                prot, rep = recovery_mod.recover_from_rank_loss(
                    self.protector, self.prot, fault.rank,
                    freeze=self._freeze, resume=self._resume)
            elif fault.kind == "scribble":
                prot, rep = recovery_mod.recover_from_scribble(
                    self.protector, self.prot, fault.locations,
                    freeze=self._freeze, resume=self._resume)
            elif fault.kind == "multi_loss":
                prot, rep = recovery_mod.recover_from_e_loss(
                    self.protector, self.prot, fault.ranks,
                    freeze=self._freeze, resume=self._resume)
            else:
                raise ValueError(
                    f"no recovery path for fault {fault.kind!r}")
            self.prot = prot
            if reverify:
                t_rv = time.perf_counter()
                self._reverify(rep)
                rep.reverify_ms = (time.perf_counter() - t_rv) * 1e3
            if self._engine is not None:
                # failure suspicion collapses the window toward 1
                self._engine.report_pressure(True)
                self.scrubber.note_suspect()
                if meta is not None:
                    rep.window_bound = {
                        "pending": meta["pending"],
                        "dirty_pages": meta["dirty_pages"],
                        "digest_verified":
                            self._engine.verify_window_bound(self._est),
                    }
            rep.queue_wait_ms = queue_wait_ms
            rep.total_ms = (time.perf_counter() - t_total) * 1e3
            self._publish_recovery(rep)
            ev = rep.to_event()
            # the span's own `kind` ("recovery") wins; the report's kind
            # rides as recovery_kind
            ev["recovery_kind"] = ev.pop("kind")
            span.annotate(**ev)
            return rep

    def _over_budget(self, ranks) -> Optional[RuntimeError]:
        """The budget-exhausted error of a loss of `ranks`, or None: the
        verdict agreed across a split zone's processes, so that no process
        falls back to its checkpoint tier while another waits in the
        solve's exchanges."""
        try:
            self.protector.check_budget(ranks)
            err = None
        except RuntimeError as e:
            err = e
        group = self.mesh.group
        if group is not None and not group.agree(err is None) and (
                err is None):
            err = RuntimeError(
                f"syndrome budget exhausted: another process of the zone "
                f"refused the simultaneous loss of ranks {list(ranks)} "
                f"(redundancy={self.redundancy}); restore from the "
                "checkpoint tier and re-arm (pool.init)")
        return err

    def _publish_recovery(self, rep: recovery_mod.RecoveryReport) -> None:
        self._suspect = True                  # until the next clean scrub
        self._n_recoveries += 1
        self._last_reverify_ok = rep.reverified
        reg = self.metrics
        reg.counter("pool_recoveries_total", kind=rep.kind).inc()
        for name, v in (("pool_recovery_solve_ms", rep.solve_ms),
                        ("pool_recovery_reverify_ms", rep.reverify_ms),
                        ("pool_recovery_queue_wait_ms", rep.queue_wait_ms),
                        ("pool_recovery_total_ms", rep.total_ms)):
            if v is not None:
                reg.histogram(name).observe(v)
        if rep.reverified is False:
            reg.counter("pool_reverify_failed_total").inc()

    def _reverify(self, rep: recovery_mod.RecoveryReport) -> None:
        """Re-run the syndrome / checksum / row-cache verification after a
        reconstruction; folds the verdict into the report."""
        mode = self.protector.mode
        if not (mode.has_parity or mode.has_cksums):
            return
        out = self.protector.scrub(self.prot)
        ok = True
        if "synd_ok" in out:
            rep.synd_ok = [bool(v) for v in out["synd_ok"].tolist()]
            ok = ok and all(rep.synd_ok)
        if "bad_pages" in out:
            ok = ok and not self.protector.zone_any(out["bad_pages"])
        if "row_cache_ok" in out:
            ok = ok and bool(out["row_cache_ok"])
        rep.reverified = ok
        rep.verified = bool(rep.verified) and ok

    # -- rescale ------------------------------------------------------------------

    def rescale(self, new_mesh: sharding.ZoneMesh, *,
                into: Optional["Pool"] = None) -> Optional["Pool"]:
        """Move the pool to `new_mesh` (elastic resize); returns the new
        pool.  The open window lands first (flush-before-rescale); then the
        state reshards bit-exactly and protection is rebuilt for the new
        zone geometry (G changes the row padding, the page owners and every
        syndrome's coefficients g^(k·i), so no plane moves with the state).
        `into` is a cold pool already built for `new_mesh`; by default one
        is opened with this pool's config and open arguments, on its
        device, publishing into its metrics and tracer.

        A split pool moves to a mesh over the same process group (W divides
        both G) or over another subgroup of its world
        (`sharding.split_mesh`): every process of the world calls this, or
        `Pool.join` where it holds no pool of the old mesh; only the rows
        that change owner move (none of a data-sharded leaf over one
        group, where no process gathers the global state), and the step
        counter is sent to the newcomers.  On a process that leaves (a
        spare of `new_mesh`) it returns None, and this pool is not used
        again.  A move between a one-process zone and a split one is
        refused."""
        if self.prot is None:
            raise RuntimeError("Pool.rescale before init()")
        procs.refuse_regroup(self.mesh, new_mesh)
        self.flush()
        with self.tracer.span("rescale") as span:
            if into is None and not new_mesh.is_spare:
                into = Pool(new_mesh, self.abstract_state, self.state_specs,
                            self.config, **self._open_kw)
            _, prot = elastic.move(
                self.prot, self.state_specs, self.mesh, new_mesh,
                lambda _m: into.protector, self.abstract_state, self.device)
            span.annotate(groups=(self.protector.group_size,
                                  new_mesh.group_size))
        self.metrics.counter("pool_rescales_total").inc()
        if into is None:
            return None
        into.prot = prot
        return into

    @classmethod
    def join(cls, old_mesh: sharding.ZoneMesh, new_mesh: sharding.ZoneMesh,
             abstract_state: PyTree, state_specs: PyTree,
             config: Optional[ProtectConfig] = None, *,
             into: Optional["Pool"] = None, **kw) -> Optional["Pool"]:
        """`rescale`'s counterpart on a process that is a spare of
        `old_mesh` (it holds no pool there): take part in the move of the
        old mesh's pools onto `new_mesh` and return this process's pool of
        it — `into`, a cold pool already built for `new_mesh`, or one
        opened with `config` and `Pool`'s keywords —, or None where it is
        a spare of `new_mesh` too.  Every process of the world calls
        `rescale` or this, in the same order."""
        if not old_mesh.is_spare:
            raise ValueError("a process that holds a pool of the old mesh "
                             "moves it with pool.rescale")
        procs.refuse_regroup(old_mesh, new_mesh)
        if into is None and not new_mesh.is_spare:
            into = cls(new_mesh, abstract_state, state_specs, config, **kw)
        device = (into.device if into is not None
                  else utils.resolve_device(kw.get("device")))
        _, prot = elastic.move(None, state_specs, old_mesh, new_mesh,
                               lambda _m: into.protector,
                               utils.abstract(abstract_state), device)
        if into is None:
            return None
        with into.tracer.span("rescale") as span:
            into.prot = prot
            span.annotate(groups=(old_mesh.group_size, new_mesh.group_size),
                          joined=True)
        into.metrics.counter("pool_rescales_total").inc()
        return into

    # -- freeze/resume hooks ----------------------------------------------------

    def _freeze(self):
        """Paper's pool freeze: drain outstanding work before repair."""
        if self.on_freeze is not None:
            self.on_freeze()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _resume(self):
        if self.on_resume is not None:
            self.on_resume()


class PoolHost:
    """Mixin for runtimes that own `self.pool` (None on an unprotected
    runtime).  Delegates the low-level handles tests poke (`protector`,
    `scrubber`, `prot`, `_engine`, `_est`) plus `flush()`, so every host
    exposes the same surface."""

    pool: Optional[Pool] = None

    @property
    def protector(self):
        return self.pool.protector if self.pool is not None else None

    @property
    def scrubber(self):
        return self.pool.scrubber if self.pool is not None else None

    @property
    def prot(self):
        return self.pool.prot if self.pool is not None else None

    @prot.setter
    def prot(self, value):
        if self.pool is not None:
            self.pool.prot = value
        elif value is not None:
            raise ValueError("an unprotected host holds no prot")

    @property
    def _engine(self):
        return self.pool.engine if self.pool is not None else None

    @property
    def _est(self):
        return self.pool._est if self.pool is not None else None

    @_est.setter
    def _est(self, value):
        self.pool._est = value

    def flush(self) -> None:
        """Bring deferred redundancy current (no-op when synchronous)."""
        if self.pool is not None:
            self.pool.flush()


def protector_for(mesh: sharding.ZoneMesh, abstract_state: PyTree,
                  state_specs: PyTree, config: ProtectConfig) -> Protector:
    """The Protector of a pool of this shape and config."""
    return Protector(
        mesh, abstract_state, state_specs,
        mode=config.resolved_mode,
        redundancy=config.resolved_redundancy,
        block_words=config.block_words,
        hybrid_threshold=config.hybrid_threshold,
        log_capacity=config.log_capacity,
        stream_threshold_words=config.stream_threshold_words,
        stream_chunk_words=config.stream_chunk_words)
