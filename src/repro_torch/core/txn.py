"""Fault-tolerant transactions over zone-stacked state (Pangolin §3.4).

The `Protector` wraps a state pytree with Pangolin's protection stack:

    prot      = protector.init(state)                      # parity+checksums
    prot', ok = protector.commit(prot, new_state, ...)     # transactional update
    report    = protector.scrub(prot)                      # verification
    prot', ok = protector.recover_rank(prot, lost)         # online media recovery
    prot', ok = protector.recover_e(prot, lost_ranks)      # e <= r losses
    prot', ok = protector.repair_pages(prot, ranks, pages) # scribble repair

It is the synchronous engine of the reference (core/txn.py), at any
redundancy r = 1..4, computing the same bytes.  Every state leaf and every
protection field is zone-stacked — `(*mesh_dims, ...)`, one entry per
device of the reference's mesh (dist/sharding.py) — so one call covers the
whole zone and the reference's collectives become folds over the data dim.

Verdicts follow the reference exactly.  A zone's verdict is the AND over
its data ranks (the reference's `pmin` over the data axis), so it is per
device, `(*mesh_dims)`, and every zone-stacked field selects per device.
The scalar verdict, step and redo log are what the reference's host sees:
the values of the device at mesh coordinate 0.

On a zone split over processes (`ZoneMesh(..., group=)`, dist/procs.py)
each process holds its block of G / W data ranks, `(*mesh.local_dims,
...)`, and runs this engine on it: ranks are global, the zone's AND is
taken across the processes, the canary verdict is agreed before a commit
branches on it, and every process ends with the same verdicts, step and
redo log as the one-process engine — its fields are that engine's, block
for block.

Protection-mode ladder (paper Table 2):
  NONE   ~ Pangolin baseline (micro-buffering + canary only)
  ML     ~ + metadata/redo-log replication
  MLP    ~ + XOR parity (media-error recovery)
  MLPC   ~ + object checksums (scribble detection)
  REPLICA~ libpmemobj's replicated mode (2x storage)
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch import utils
from repro_torch.core import checksum as ck
from repro_torch.core import gf
from repro_torch.core import layout as layout_mod
from repro_torch.core import parity as parity_mod
from repro_torch.core import redolog
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import P, ZoneMesh
from repro_torch.kernels import ops as kops
from repro_torch.obs.trace import layer

PyTree = Any


class Mode(enum.Enum):
    NONE = "none"          # micro-buffering + canary only (pgl baseline)
    ML = "ml"              # + redo-log/metadata replication
    MLP = "mlp"            # + parity (syndrome stack, height = redundancy)
    MLPC = "mlpc"          # + checksums
    REPLICA = "replica"    # full replica (Pmemobj-R analogue)

    @property
    def has_parity(self) -> bool:
        return self in (Mode.MLP, Mode.MLPC)

    @property
    def has_cksums(self) -> bool:
        return self is Mode.MLPC

    @property
    def has_log(self) -> bool:
        return self in (Mode.ML, Mode.MLP, Mode.MLPC)

    @property
    def has_replica(self) -> bool:
        return self is Mode.REPLICA


MAX_REDUNDANCY = 4
_MODE_ALIASES = {"mlp2": ("mlp", 2), "mlpc2": ("mlpc", 2)}


def resolved_mode(mode, redundancy: int = 1) -> tuple:
    """Resolve (mode-or-alias, redundancy) to the (Mode, r) pair, as the
    reference does ("mlp2"/"mlpc2" alias redundancy 2)."""
    implied = 1
    if isinstance(mode, Mode):
        m = mode
    else:
        name, implied = _MODE_ALIASES.get(mode, (mode, 1))
        m = Mode(name)
    r = max(int(redundancy), implied)
    if not 1 <= int(redundancy) <= MAX_REDUNDANCY or \
            not 1 <= r <= MAX_REDUNDANCY:
        raise ValueError(
            f"redundancy={redundancy} — the syndrome stack holds 1 to "
            f"{MAX_REDUNDANCY} syndromes (1 = XOR parity P, 2 adds the "
            "GF(2^32) Q row, 3-4 add higher Vandermonde rows)")
    if r > 1 and not m.has_parity:
        raise ValueError(
            f"redundancy={r} with mode='{m.value}' — extra syndromes "
            "extend parity, they cannot replace it; use a parity mode "
            "(mlp or mlpc)")
    return m, r


@dataclasses.dataclass
class ProtectedState:
    state: PyTree                    # zone-stacked leaves (*mesh_dims, *local)
    synd: Optional[torch.Tensor]     # (*mesh_dims, r, seg_words) int32
    cksums: Optional[torch.Tensor]   # (*mesh_dims, n_blocks, 2) int32
    digest: Optional[torch.Tensor]   # (*mesh_dims, 2) int32 whole-row digest
    replica: Optional[PyTree]
    log: Optional[redolog.RedoLog]
    step: torch.Tensor               # 0-d int32 (u32 bits)
    # Cached word row, (*mesh_dims, row_words) int32.  Invariant:
    # row == flatten_row(layout, state) whenever protection is active.
    row: Optional[torch.Tensor] = None

    @property
    def parity(self) -> Optional[torch.Tensor]:
        """The S_0 (XOR parity) plane of the syndrome stack."""
        return None if self.synd is None else self.synd[..., 0, :]


def tree_select(pred: torch.Tensor, on_true, on_false):
    """Select whole values on a 0-d device bool, as the reference's
    `tree_select`: tensors, pytrees of them and dataclasses (ProtectedState,
    RedoLog, EpochState) field by field; None stays None."""
    if on_true is None:
        return None
    if dataclasses.is_dataclass(on_true):
        return dataclasses.replace(on_true, **{
            f.name: tree_select(pred, getattr(on_true, f.name),
                                getattr(on_false, f.name))
            for f in dataclasses.fields(on_true)})
    if isinstance(on_true, torch.Tensor):
        return torch.where(pred, on_true, on_false)
    return utils.tree_map(lambda t, f: tree_select(pred, t, f), on_true,
                          on_false)


def device_bool(v, device) -> torch.Tensor:
    """A verdict as a 0-d bool tensor on `device`: a host bool is filled
    in there (no copy), a tensor only reshaped."""
    if isinstance(v, torch.Tensor):
        return v.reshape(()).to(torch.bool)
    return torch.full((), bool(v), dtype=torch.bool, device=device)


def select(ok: torch.Tensor, new: torch.Tensor,
           old: torch.Tensor) -> torch.Tensor:
    """Per-device select: `ok` is `(*mesh_dims)` (or 0-d); `new`/`old` are
    zone-stacked tensors with those leading dims."""
    return torch.where(ok.reshape(*ok.shape, *([1] * (new.dim() - ok.dim()))),
                       new, old)


class Protector:
    """The synchronous protection engine for one zone layout."""

    def __init__(self, mesh: ZoneMesh, abstract_state: PyTree,
                 state_specs: PyTree, *, mode: Mode = Mode.MLPC,
                 redundancy: int = 1,
                 block_words: int = layout_mod.PAGE_WORDS,
                 hybrid_threshold: float = 0.5,
                 log_capacity: int = 64,
                 stream_threshold_words: int = 1 << 20,
                 stream_chunk_words: int = 1 << 16):
        mode, redundancy = resolved_mode(mode, redundancy)
        self.mesh = mesh
        self.mode = mode
        self.group_size = mesh.group_size
        if mode.has_parity and redundancy > self.group_size - 1:
            raise ValueError(
                f"redundancy={redundancy} on a zone of {self.group_size} "
                f"data ranks — at most num_ranks - 1 = "
                f"{self.group_size - 1} simultaneous losses are solvable")
        self.redundancy = redundancy if mode.has_parity else 1
        self.hybrid_threshold = hybrid_threshold
        self.log_capacity = log_capacity
        self.stream_threshold_words = int(stream_threshold_words)
        self.stream_chunk_words = int(stream_chunk_words)
        self.state_specs = state_specs
        self.layout = layout_mod.build_layout(
            abstract_state, self.group_size, state_specs, mesh,
            block_words=block_words)
        self._programs: dict = {}
        self._coeff_tables: dict = {}

    # -- zone helpers ---------------------------------------------------------

    @property
    def data_dim(self) -> int:
        return self.mesh.data_dim

    @property
    def group(self):
        """The process group of a split zone (None on one process)."""
        return self.mesh.group

    def rank_index(self, device) -> torch.Tensor:
        """`(*mesh_dims)` int64: each device's (global) rank along the zone
        axis."""
        shape = [1] * len(self.mesh.shape)
        shape[self.data_dim] = self.mesh.local_group_size
        lo = self.mesh.data_offset
        return torch.arange(lo, lo + self.mesh.local_group_size,
                            device=device).reshape(shape).expand(
                                self.mesh.local_dims)

    def coeffs(self, device) -> Optional[torch.Tensor]:
        """Every device's syndrome coefficients, `(*mesh_dims, r)` int32 on
        `device` (built once per device), or None at r = 1."""
        if self.redundancy == 1:
            return None
        key = str(device)
        if key not in self._coeff_tables:
            self._coeff_tables[key] = gf.rank_syndrome_coeffs(
                self.group_size, self.redundancy, self.mesh, device)
        return self._coeff_tables[key]

    def _zone_all(self, ok: torch.Tensor) -> torch.Tensor:
        """AND over each zone's ranks, back on every device (the `pmin`)."""
        coll.note_all_reduce(ok, self.group_size, 4)
        ok = ok.all(dim=self.data_dim, keepdim=True)
        if self.group is not None:
            ok = self.group.all_and(ok)
        return ok.expand(self.mesh.local_dims)

    def _all(self, ok: torch.Tensor) -> torch.Tensor:
        """A 0-d AND over every device of the mesh, all processes'."""
        ok = ok.all()
        return ok if self.group is None else self.group.all_and(ok)

    def zone_any(self, x: torch.Tensor) -> bool:
        """Host OR of a bool tensor over every device of the mesh."""
        return not bool(self._all(~x))

    def _zone_clean(self, ok: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
        """AND `no page is bad` into ok, agreed across each zone."""
        return self._zone_all(ok & ~bad.any(dim=-1))

    @staticmethod
    def _first(x: torch.Tensor, n_axes: int) -> torch.Tensor:
        """The value at this process's first mesh coordinate — mesh
        coordinate 0, what the reference's host sees of a replicated
        output, on one process."""
        return x.reshape(-1, *x.shape[n_axes:])[0]

    def _first_of_zone(self, x: torch.Tensor, n_axes: int) -> torch.Tensor:
        """The value at mesh coordinate 0, which the first process holds,
        on every process."""
        first = self._first(x, n_axes)
        return first if self.group is None else self.group.all_gather(
            first)[0]

    # -- sharding helpers (the dry run's abstract inputs) ---------------------

    def parity_sharding(self) -> tuple:
        """(mesh, spec) of every zone-stacked protection field: the
        reference's `NamedSharding(mesh, P(*axis_names))` as the (mesh,
        spec) pair dist/sharding.py places leaves by."""
        return self.mesh, P(*self.mesh.axis_names)

    def abstract_protected(self, abstract_state: PyTree) -> ProtectedState:
        """A `ProtectedState` of `device="meta"` tensors (no bytes): the
        global `abstract_state` zone-stacked by `state_specs`, as `init`
        holds a state, and the reference's protection fields —
        `(*mesh_dims, r, seg_words)` syndromes, `(*mesh_dims, n_blocks, 2)`
        checksums, the digest, the row, the replica and the redo log —
        present as the mode keeps them."""
        lo, mode = self.layout, self.mode
        zdims = tuple(self.mesh.shape)

        def words(*shape):
            return torch.empty(zdims + shape, dtype=utils.WORD, device="meta")

        def zone(leaves):
            return utils.tree_map(
                lambda x, spec: shd.shard(
                    torch.empty(x.shape, dtype=x.dtype, device="meta"), spec,
                    self.mesh), leaves, self.state_specs)
        kept = mode.has_parity or mode.has_cksums
        return ProtectedState(
            state=zone(abstract_state),
            synd=(words(self.redundancy, lo.seg_words) if mode.has_parity
                  else None),
            cksums=words(lo.n_blocks, 2) if mode.has_cksums else None,
            digest=words(2) if kept else None,
            replica=zone(abstract_state) if mode.has_replica else None,
            log=(redolog.make(self.log_capacity, "meta") if mode.has_log
                 else None),
            step=torch.empty((), dtype=utils.WORD, device="meta"),
            row=words(lo.row_words) if kept else None)

    def protected_specs(self) -> ProtectedState:
        """The partition specs matching `abstract_protected`, the
        reference's: the state's own, `P(*axis_names)` for the zone-stacked
        protection fields, `P()` for the redo log and the step."""
        mode = self.mode
        z = P(*self.mesh.axis_names)
        kept = mode.has_parity or mode.has_cksums
        log = None
        if mode.has_log:
            log = redolog.RedoLog(*(P(),) * len(
                dataclasses.fields(redolog.RedoLog)))
        return ProtectedState(
            state=self.state_specs,
            synd=z if mode.has_parity else None,
            cksums=z if mode.has_cksums else None,
            digest=z if kept else None,
            replica=self.state_specs if mode.has_replica else None,
            log=log, step=P(), row=z if kept else None)

    # -- streaming policy -----------------------------------------------------

    def stream_chunk(self) -> Optional[int]:
        """Pages per streamed chunk for full-row sweeps, or None when the
        local row is below `stream_threshold_words` (flat kernels)."""
        lo = self.layout
        return kops.stream_chunk_blocks(
            lo.n_blocks, lo.block_words,
            threshold_words=self.stream_threshold_words,
            chunk_words=self.stream_chunk_words)

    # -- init -----------------------------------------------------------------

    def init(self, state: PyTree) -> ProtectedState:
        """Protect zone-stacked `state` (the tensors are held, not copied)."""
        lo, mode = self.layout, self.mode
        row = layout_mod.flatten_row(lo, state)
        device = row.device
        synd = cksums = dig = None
        if mode.has_parity:
            synd = parity_mod.build_syndromes(row, self.data_dim,
                                              self.coeffs(device), self.group)
        if mode.has_cksums:
            cksums = ck.block_checksums(row, lo.block_words)
            dig = ck.combine(cksums, lo.block_words)
        elif mode.has_parity:
            dig = ck.digest(row, lo.block_words)
        keep_row = mode.has_parity or mode.has_cksums
        replica = (utils.tree_map(torch.clone, state) if mode.has_replica
                   else None)
        log = (redolog.make(self.log_capacity, device) if mode.has_log
               else None)
        return ProtectedState(
            state=state, synd=synd, cksums=cksums, digest=dig,
            replica=replica, log=log,
            step=torch.zeros((), dtype=utils.WORD, device=device),
            row=row if keep_row else None)

    # -- commit ---------------------------------------------------------------

    def make_commit(self, dirty_pages: Optional[Sequence[int]] = None,
                    verify_old: bool = False):
        """Build the commit function for one static path.

        `dirty_pages`: page indices when the update's footprint is known;
        None = whole state dirty; [] = metadata only.  Below the
        `hybrid_threshold` fraction the patch path sweeps the dirty pages
        only; otherwise the bulk path sweeps the row — flat, or streamed
        (the kernel adds the row digest) once the row reaches
        `stream_threshold_words`.  `verify_old` re-flattens the old row
        from the live state and verifies it against the checksums in the
        same sweep; a mismatch anywhere in a zone aborts that zone.  At
        r >= 2 the sweeps emit every rank's r weighted delta planes from
        the one read of (old, new); at r = 1 they route to the
        single-parity kernels.
        """
        lo, mode, r = self.layout, self.mode, self.redundancy
        bw, dd = lo.block_words, self.data_dim
        n_axes = len(self.mesh.shape)
        meta_only = dirty_pages is not None and len(dirty_pages) == 0
        patch = (dirty_pages is not None and not meta_only
                 and len(dirty_pages) / lo.n_blocks < self.hybrid_threshold)
        dirty_leaves = (layout_mod.leaves_for_pages(lo, dirty_pages)
                        if (meta_only or patch) else None)
        dirty_idx = [int(p) for p in dirty_pages] if patch else None
        scb = self.stream_chunk()
        protected = mode.has_parity or mode.has_cksums
        idx_by_device: dict = {}

        def page_index(device):
            """The dirty page list on `device`, copied there once."""
            if str(device) not in idx_by_device:
                idx_by_device[str(device)] = utils.to_device(dirty_idx,
                                                             device)
            return idx_by_device[str(device)]

        def _protect(prot: ProtectedState, state_new, row_old):
            """New (row, synd, cksums, digest) and the per-device verdict."""
            if meta_only or patch:
                row_new = layout_mod.update_row(lo, row_old, state_new,
                                                dirty_leaves)
            else:
                row_new = layout_mod.flatten_row(lo, state_new)
            ok = torch.ones(self.mesh.local_dims, dtype=torch.bool,
                            device=row_new.device)
            coeffs = self.coeffs(row_new.device)
            synd, cksums, digest = prot.synd, prot.cksums, prot.digest
            if meta_only:
                pass          # the paper's "free" metadata-only transaction
            elif patch:
                idx = page_index(row_new.device)
                old_pages = parity_mod.gather_pages(row_old, idx, bw)
                new_pages = parity_mod.gather_pages(row_new, idx, bw)
                if mode.has_cksums:
                    if verify_old:
                        sdelta, fresh, bad = kops.fused_verify_commit_s(
                            old_pages, new_pages, prot.cksums[..., idx, :],
                            coeffs)
                        ok = self._zone_clean(ok, bad)
                    else:
                        sdelta, fresh = kops.fused_commit_s(
                            old_pages, new_pages, coeffs)
                    cksums = ck.set_blocks(prot.cksums, fresh, idx)
                    digest = ck.combine(cksums, bw)
                else:
                    sdelta, fresh, old_ck = kops.fused_commit_old_terms_s(
                        old_pages, new_pages, coeffs)
                    digest = ck.update_digest(prot.digest, old_ck, fresh,
                                              idx, lo.n_blocks, bw)
                if mode.has_parity:
                    synd = parity_mod.patch_syndrome_delta(
                        prot.synd, sdelta, idx, lo, dd, self.group)
            else:
                pages_new = parity_mod.page_view(row_new, bw)
                dig_new = None
                if verify_old and mode.has_cksums:
                    # old is swept for verify anyway: the same pass yields
                    # the r weighted deltas the stack consumes
                    # (S ^ rs(sdelta) == rs-stack(new))
                    pages_old = parity_mod.page_view(row_old, bw)
                    if scb is None:
                        sdelta, fresh, bad = kops.fused_verify_commit_s(
                            pages_old, pages_new, prot.cksums, coeffs)
                    else:
                        sdelta, fresh, bad, dig_new = (
                            kops.fused_verify_commit_s_stream(
                                pages_old, pages_new, prot.cksums, coeffs))
                    ok = self._zone_clean(ok, bad)
                    if mode.has_parity:
                        synd = parity_mod.apply_sdelta(
                            prot.synd,
                            sdelta.reshape(*self.mesh.local_dims, r, -1), dd,
                            self.group)
                else:
                    # without verify the old row is not read at all
                    if scb is None:
                        fresh = kops.fletcher_blocks(pages_new)
                    else:
                        fresh, dig_new = kops.fletcher_stream(
                            pages_new, chunk_blocks=scb)
                    if mode.has_parity:
                        synd = parity_mod.build_syndromes(row_new, dd, coeffs,
                                                          self.group)
                if mode.has_cksums:
                    cksums = fresh
                digest = ck.combine(fresh, bw) if dig_new is None else dig_new
            return ok, row_new, synd, cksums, digest

        def commit(prot: ProtectedState, state_new: PyTree, *,
                   data_cursor: int = 0, rng_key=None,
                   canary_ok: bool = True):
            """`state_new` is zone-stacked like `prot.state`.  `rng_key`:
            the step's two RNG key words (default (0, 0), the words of
            the reference's PRNGKey(0)).  Returns (successor, ok) with
            `ok` a 0-d bool tensor (no host sync).  On a split zone the
            processes agree on the canary first: one smashed canary aborts
            the commit on every process."""
            _check_like(state_new, prot.state)
            if self.group is not None:
                canary_ok = self.group.agree(canary_ok)
            step = prot.step + 1
            device = prot.step.device
            ok_dev = torch.full(self.mesh.local_dims, bool(canary_ok),
                                device=device)
            row, synd, cksums, digest = (prot.row, prot.synd, prot.cksums,
                                         prot.digest)
            digest_for_log = torch.zeros(2, dtype=utils.WORD, device=device)
            if protected:
                row_old = (layout_mod.flatten_row(lo, prot.state)
                           if verify_old else prot.row)
                row = row_old
                if canary_ok:
                    ok_dev, row_new, synd_n, ck_n, dig_n = _protect(
                        prot, state_new, row_old)
                    row = select(ok_dev, row_new, row_old)
                    digest = select(ok_dev, dig_n, prot.digest)
                    if mode.has_parity:
                        synd = select(ok_dev, synd_n, prot.synd)
                    if mode.has_cksums:
                        cksums = select(ok_dev, ck_n, prot.cksums)
                # the reference's log takes the digest replicated: an
                # all-reduce over every device of the mesh
                coll.note_all_reduce(digest, math.prod(self.mesh.shape))
                digest_for_log = self._first_of_zone(digest, n_axes)
            ok = self._first(ok_dev, n_axes)
            # paper ordering: the log record persists before the object
            # writes; the commit mark follows the protected update
            log = prot.log
            if mode.has_log:
                log = redolog.append(prot.log, step, data_cursor,
                                     (0, 0) if rng_key is None else rng_key,
                                     digest_for_log)
                marked = redolog.commit_mark(log, step)
                log = dataclasses.replace(log, mark=torch.where(
                    ok, marked.mark, log.mark))
            new_state = utils.tree_map(lambda n, o: select(ok_dev, n, o),
                                       state_new, prot.state)
            replica = prot.replica
            if mode.has_replica:
                replica = utils.tree_map(lambda n, o: select(ok_dev, n, o),
                                         state_new, prot.replica)
            return ProtectedState(
                state=new_state, synd=synd, cksums=cksums, digest=digest,
                replica=replica, log=log,
                step=torch.where(ok, step, prot.step), row=row), ok

        return commit

    def commit(self, prot, state_new, *, dirty_pages=None, verify_old=False,
               **kw):
        """Cached commit entry point (see `commit_program`)."""
        return self.commit_program(
            dirty_pages=dirty_pages, verify_old=verify_old)(
                prot, state_new, **kw)

    def commit_program(self, *, dirty_pages=None, verify_old=False):
        """The commit function for one (dirty set, verify) key — the
        reference's cache key less `donate`: this slice builds every
        successor functionally, never in place."""
        with layer("txn.commit_program"):
            key = ("commit",
                   tuple(int(p) for p in dirty_pages)
                   if dirty_pages is not None else None,
                   bool(verify_old))
            if key not in self._programs:
                with layer("txn.commit_build"):
                    self._programs[key] = self.make_commit(
                        dirty_pages=dirty_pages, verify_old=verify_old)
            return self._programs[key]

    # -- scrub ----------------------------------------------------------------

    def scrub(self, prot: ProtectedState) -> dict:
        """One flatten of the live state feeds the checksum verify, the
        parity invariant and the row-cache check.  Outputs: `bad_pages`
        `(*mesh_dims, n_blocks)` bool (this process's ranks on a split
        zone), `synd_ok` `(r,)` bool (zone at mesh coordinate 0, as the
        reference's host sees it), `row_cache_ok` 0-d bool over every
        device."""
        lo, mode = self.layout, self.mode
        row = layout_mod.flatten_row(lo, prot.state)
        out = {}
        if mode.has_cksums:
            out["bad_pages"] = ck.verify_blocks(row, prot.cksums,
                                                lo.block_words)
        if mode.has_parity:
            ok = parity_mod.verify_syndromes(row, prot.synd, self.data_dim,
                                             self.coeffs(row.device),
                                             self.group)
            out["synd_ok"] = ok.reshape(-1, ok.shape[-1])[0]
        if mode.has_parity or mode.has_cksums:
            out["row_cache_ok"] = self._all(row == prot.row)
        return out

    def local_scrub(self, prot: ProtectedState) -> dict:
        """Rank-local pre-check: the checksum verify reduced to a mismatch
        count, the row-cache check, and each rank's syndrome segments
        against a *folded* syndrome — each rank XOR-folds its weighted row
        per (syndrome, owner segment) into an (r, G) word matrix, the
        zone XOR-combines those, and each owner compares the fold of its
        stored segments.  The rows are weighted into their r planes by the
        `sdelta_stack` kernel (at r >= 2).  A fold catches any single
        corruption."""
        lo, mode, r, g = self.layout, self.mode, self.redundancy, \
            self.group_size
        dd, shape, group = self.data_dim, self.mesh.local_dims, self.group
        row = layout_mod.flatten_row(lo, prot.state)
        out = {}
        if mode.has_cksums:
            bad = ck.verify_blocks(row, prot.cksums, lo.block_words)
            out["bad_count"] = (bad.sum() if group is None else
                                group.all_gather(bad.sum()).sum())
        if mode.has_parity:
            weighted = kops.syndrome_scale(row, self.coeffs(row.device))
            segs = weighted.reshape(*shape, r, g, -1)
            folds = coll.xor_fold(segs, dim=-1)              # (*M, r, G)
            want = coll.xor_all_reduce(folds, dd, group)     # (*M, r, G)
            me = self.rank_index(row.device)
            want_me = torch.take_along_dim(
                want, me[..., None, None].expand(*shape, r, 1), dim=-1)
            mine = coll.xor_fold(prot.synd, dim=-1)          # (*M, r)
            ok = (mine == want_me[..., 0]).all(dim=dd)       # per zone
            if group is not None:
                ok = group.all_and(ok)
            out["synd_ok"] = ok.reshape(-1, r)[0]
        if mode.has_parity or mode.has_cksums:
            out["row_cache_ok"] = self._all(row == prot.row)
        return out

    # -- recovery -------------------------------------------------------------

    def _verified(self, row_out: torch.Tensor, prot: ProtectedState):
        """Post-repair verdict: no bad page in the zone at coordinate 0."""
        if not self.mode.has_cksums:
            return torch.ones((), dtype=torch.bool, device=row_out.device)
        bad = ck.verify_blocks(row_out, prot.cksums, self.layout.block_words)
        ok = ~bad.any(dim=-1).any(dim=self.data_dim)
        if self.group is not None:
            ok = self.group.all_and(ok)
        return ok.reshape(-1)[0]

    def recover_rank(self, prot: ProtectedState, lost_rank: int) -> tuple:
        """Online reconstruction of one lost data rank's row in every zone.
        The live (damaged) state is flattened: the row cache is rebuilt,
        never trusted, across recovery."""
        lo, dd = self.layout, self.data_dim
        row = layout_mod.flatten_row(lo, prot.state)
        rebuilt = parity_mod.reconstruct_row(row, prot.synd[..., 0, :],
                                             lost_rank, dd, self.group)
        lost = self.rank_index(row.device) == int(lost_rank)
        row_out = select(lost, rebuilt, row)
        return dataclasses.replace(
            prot, state=layout_mod.unflatten_row(lo, row_out),
            row=row_out), self._verified(row_out, prot)

    def check_budget(self, lost_ranks) -> None:
        """Raise when the simultaneous loss of `lost_ranks` exceeds what the
        syndrome stack solves online (e > r; r = 0 without parity): an
        e x e solve through an r < e stack would return garbage rows."""
        ranks = [int(a) for a in lost_ranks]
        e = len(ranks)
        r = self.redundancy if self.mode.has_parity else 0
        if e > r:
            raise RuntimeError(
                f"syndrome budget exhausted: ranks {ranks} are lost "
                f"simultaneously (e={e}) but this pool holds redundancy={r} "
                "syndrome row(s) — at most r losses solve online.  Restore "
                "from the checkpoint + redo-log tier and re-arm the stack by "
                "re-protecting (pool.init), or raise "
                f"ProtectConfig.redundancy>={e} (<= 4) before the next storm")

    def recover_e(self, prot: ProtectedState, lost_ranks) -> tuple:
        """Online reconstruction of e <= r lost data ranks' rows in every
        zone, through the e x e Vandermonde inverse (`parity.reconstruct_e`).
        Also the path for losses with a scribble outstanding: name the
        scribbled rank as an extra loss."""
        lo, dd = self.layout, self.data_dim
        ranks = tuple(sorted(int(a) for a in lost_ranks))
        e = len(ranks)
        if len(set(ranks)) != e:
            raise ValueError(f"erasure recovery needs distinct ranks, got "
                             f"{ranks}")
        self.check_budget(ranks)
        row = layout_mod.flatten_row(lo, prot.state)
        rebuilt = parity_mod.reconstruct_e(row, prot.synd, ranks, dd,
                                           self.coeffs(row.device), self.group)
        me = self.rank_index(row.device)
        row_out = row
        for a, row_a in zip(ranks, rebuilt):
            row_out = select(me == a, row_a, row_out)
        return dataclasses.replace(
            prot, state=layout_mod.unflatten_row(lo, row_out),
            row=row_out), self._verified(row_out, prot)

    def recover_two(self, prot: ProtectedState, lost_a: int,
                    lost_b: int) -> tuple:
        """The e = 2 erasure recovery."""
        a, b = sorted((int(lost_a), int(lost_b)))
        if a == b:
            raise ValueError("double-loss recovery needs two distinct ranks")
        return self.recover_e(prot, (a, b))

    def repair_pages(self, prot: ProtectedState, bad_rank, bad_page) -> tuple:
        """Targeted scribble repair of (rank, page) locations: each bad page
        is the XOR of the other ranks' pages and its parity page (the
        stack's S_0 plane)."""
        lo, dd = self.layout, self.data_dim
        bw = lo.block_words
        pps = lo.seg_words // bw
        row = layout_mod.flatten_row(lo, prot.state)
        device = row.device
        ranks = torch.as_tensor(np.asarray(bad_rank).reshape(-1),
                                device=device)
        pages_idx = torch.as_tensor(np.asarray(bad_page).reshape(-1),
                                    device=device)
        pages = parity_mod.page_view(row, bw)                 # (*M, nb, bw)
        me = self.rank_index(device)[..., None]               # (*M, 1)
        mine_bad = (ranks == me)[..., None]                   # (*M, k, 1)
        contents = pages[..., pages_idx, :]                   # (*M, k, bw)
        others = coll.xor_all_reduce(
            torch.where(mine_bad, 0, contents), dd, self.group)
        owner = (pages_idx // pps == me)[..., None]
        seg_pages = prot.synd[..., 0, :].reshape(*self.mesh.local_dims, pps,
                                                 bw)
        par_pages = coll.xor_all_reduce(
            torch.where(owner, seg_pages[..., pages_idx % pps, :], 0), dd,
            self.group)
        fixed = torch.where(mine_bad, others ^ par_pages, contents)
        out = pages.clone()
        out[..., pages_idx, :] = fixed
        row_out = out.reshape(row.shape)
        return dataclasses.replace(
            prot, state=layout_mod.unflatten_row(lo, row_out),
            row=row_out), self._verified(row_out, prot)

    # -- the reference's program factories ------------------------------------
    # The reference builds each scrub and recovery as a program to jit; here
    # the direct methods are that program, and a factory hands it back with
    # the reference's signature.

    def make_scrub(self):
        """`scrub(prot) -> dict`, as `Protector.scrub`."""
        return self.scrub

    def make_local_scrub(self):
        """`local_scrub(prot) -> dict`, as `Protector.local_scrub`."""
        return self.local_scrub

    def make_recover_rank(self):
        """`recover(prot, lost_rank) -> (prot, ok)`."""
        return self.recover_rank

    def make_recover_e(self, lost_ranks):
        """`recover(prot) -> (prot, ok)` for the static erasure set
        `lost_ranks`, checked here: distinct ranks, at most r of them."""
        ranks = tuple(sorted(int(a) for a in lost_ranks))
        if len(set(ranks)) != len(ranks):
            raise ValueError(f"erasure recovery needs distinct ranks, got "
                             f"{ranks}")
        self.check_budget(ranks)
        return lambda prot: self.recover_e(prot, ranks)

    def make_repair_pages(self, n_pages: int):
        """`repair(prot, bad_rank, bad_page) -> (prot, ok)` for `n_pages`
        (rank, page) locations."""
        def repair(prot: ProtectedState, bad_rank, bad_page):
            return self.repair_pages(
                prot, np.asarray(bad_rank).reshape(n_pages),
                np.asarray(bad_page).reshape(n_pages))
        return repair

    # -- introspection --------------------------------------------------------

    def overhead_report(self) -> dict:
        rep = self.layout.overhead_report()
        rep["mode"] = self.mode.value
        rep["group_size"] = self.group_size
        r = self.redundancy if self.mode.has_parity else 0
        rep["redundancy"] = r
        rep["syndrome_rows"] = r
        rep["syndrome_bytes_per_rank"] = r * rep["parity_bytes_per_rank"]
        rep["syndrome_fraction"] = r * rep["parity_fraction"]
        rep["syndrome_r_over_p"] = float(r) if r else 0.0
        if self.mode.has_replica:
            rep["protection_fraction"] = 1.0
        else:
            frac = rep["syndrome_fraction"]
            if self.mode.has_cksums:
                frac += rep["checksum_fraction"]
            rep["protection_fraction"] = frac
        return rep


def _check_like(new: PyTree, old: PyTree) -> None:
    """The staged state must have the protected state's structure, shapes
    and dtypes (a mismatch would silently promote in the selects)."""
    ln, dn = utils.tree_flatten(new)
    lo_, do = utils.tree_flatten(old)
    if dn != do:
        raise ValueError("staged state's pytree structure differs from the "
                         "protected state's")
    for a, b in zip(ln, lo_):
        if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
            raise ValueError(
                f"staged leaf {tuple(a.shape)} {a.dtype} on {a.device} vs "
                f"protected {tuple(b.shape)} {b.dtype} on {b.device}")
