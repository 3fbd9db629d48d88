"""Deferred-epoch redundancy engine (the reference's core/epoch.py).

Redundancy is refreshed once per *window* of commits instead of on every
commit; the redo log still persists per commit and covers the unprotected
interval.  Two flavours, computing the reference's bytes:

  * Bulk engine (`dirty_leaf_idx=None`; every commit rewrites the row, as
    in training).  Each in-window commit is one `fused_accum_commit` sweep
    (`fused_accum_commit_stream` once the row reaches the streaming
    threshold) over (accumulator, previous row, new row): it folds the
    step's XOR delta into the epoch accumulator `acc` (deltas telescope,
    so acc == row_start ^ row_now) and yields the new page terms, so the
    checksum table and the row digest are current at every step.  The
    flush weights `acc` into the r syndrome planes (`syndrome_scale`, one
    read) and folds them into the stack (`apply_sdelta`); it never reads
    the row again.
  * Patch engine (`dirty_leaf_idx` = a static leaf list; commits touch
    those leaves only, as in decode).  An in-window commit updates the row
    digest from the modified words alone (`checksum.update_digest_words`)
    and unions the dirty pages; the stack, the checksums and the cached
    row stay at the epoch start (the pinned row is the accumulator).  The
    modified words also go into the window's `live` row, so the intended
    values sit in a buffer apart from the state, as the bulk engine's
    current row does.  The flush takes the live row and either patches
    the dirty pages (`fused_commit_s` with checksums, else `xor_delta` +
    `syndrome_scale`) or, past the hybrid threshold, rebuilds the stack
    and checksums from it.  A fault that damages the state mid-window
    therefore never reaches the redundancy that recovery rebuilds from.
    (The reference's flush splices the live state instead, so a rank loss
    or scribble mid-window on the patch engine recovers to the damaged
    words of the window's dirty pages.)

At every epoch boundary the stack, checksums, digest, row and redo log are
byte-equal to the synchronous engine's after the same commits.

The reference's programs are jitted shard_map bodies that donate their
inputs; here the step and the flush are plain functions on zone-stacked
tensors that build every successor functionally (nothing is written in
place but the patch engine's live row, which a window owns alone), and
the per-device dirty masks,
accumulators and digests carry the mesh dims in front.  Nothing in a
commit or a flush waits for the device.

On a zone split over processes (`ZoneMesh(..., group=)`, dist/procs.py)
each process runs the engine on its block of data ranks, `(*mesh.local_dims,
...)`.  An in-window bulk commit exchanges no row: its delta folds into
the block's accumulator, and only the flush pays the reduce-scatter.  The
log's digest is mesh coordinate 0's on every process (one small
all-gather, which the window-meta mirror rides when it is on: the mirror
gathers the whole zone's digests, so a lost process's rows survive on the
others).  A staged canary is agreed across the processes before anything
selects on it; a host-known canary is a global argument, the same on every
process (a `Transaction` agrees it).  The host cadence (`_since`, the
window, the boundary flush) reads only values every process holds alike,
so every process flushes at the same commit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import utils
from repro_torch.core import checksum as ck
from repro_torch.core import layout as layout_mod
from repro_torch.core import parity as parity_mod
from repro_torch.core import redolog
from repro_torch.core.txn import (ProtectedState, Protector, _check_like,
                                  device_bool, tree_select)
from repro_torch.dist import collectives as coll
from repro_torch.kernels import ops as kops


@dataclasses.dataclass
class EpochState:
    """A ProtectedState plus the open window's bookkeeping.

    `dirty`: the unioned dirty-page mask, `(*mesh_dims, n_blocks)` bool
    (patch engine; None for the bulk engine).  `pending`: successful
    commits since the last flush, a 0-d int32 (u32 bits).  `acc`: the bulk
    engine's XOR accumulator, `(*mesh_dims, row_words)` int32 (None for
    the patch engine); after W steps it holds row_start ^ row_now.
    Mid-window the patch engine's `prot.row` is the epoch-start row and
    `live` (`(*mesh_dims, row_words)` int32, None for the bulk engine) the
    row of the last committed state, which its commits write in place.
    """
    prot: ProtectedState
    dirty: Optional[torch.Tensor]
    pending: torch.Tensor
    acc: Optional[torch.Tensor] = None
    live: Optional[torch.Tensor] = None


class EngineHost:
    """Engine-or-sync protected-state plumbing (the reference's runtimes
    and `Pool` share it).  Hosts set `_engine` (a DeferredProtector, or
    None for the synchronous cadence) and track their state through the
    `prot` property.  The setter wraps the value into a fresh window,
    which discards the open window's bookkeeping: legal only for a state
    whose redundancy is current (after `Protector.init`, a flush or a
    recovery)."""
    _engine = None        # Optional[DeferredProtector]
    _est = None           # Optional[EpochState]      (engine cadence)
    _prot = None          # Optional[ProtectedState]  (sync cadence)

    @property
    def prot(self) -> Optional[ProtectedState]:
        if self._engine is not None:
            return self._est.prot if self._est is not None else None
        return self._prot

    @prot.setter
    def prot(self, value):
        if self._engine is not None:
            self._est = (self._engine.wrap(value)
                         if value is not None else None)
        else:
            self._prot = value

    def flush(self) -> None:
        """Bring deferred redundancy current (no-op when synchronous)."""
        if self._engine is not None and self._est is not None:
            self._est = self._engine.flush_if_pending(self._est)


def _word_index(wi, n_words: int, device) -> tuple:
    """A leaf's word-index array -> (indices as int64, in-range mask).
    Entries at or past the leaf's word count read 0 from both sides (the
    reference's gather `mode="fill"`).  Indices are non-negative, as
    `layout.time_slice_words` gives them."""
    wi = utils.to_device(wi, device).to(torch.int64).reshape(-1)
    return wi, wi < n_words


def dirty_slots(mask: torch.Tensor, kf: int) -> tuple:
    """The first `kf` set entries of a 1-D bool mask in ascending order,
    the rest of the `kf` slots filled with the sentinel len(mask) — the
    reference's `jnp.nonzero(mask, size=kf, fill_value=nb)` — without a
    host sync (a stable sort puts the set entries first).  Returns
    (indices, valid)."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)[:kf]
    valid = mask[order]
    return torch.where(valid, order, mask.shape[-1]), valid


class DeferredProtector:
    """Windowed protection over a Protector's zone layout.

    `window` commits trigger an automatic flush.  Patch engines take
    `dirty_words` at commit: a tuple aligned with `dirty_leaf_idx` of
    per-leaf word-index arrays (or None = the whole leaf), e.g. from the
    reference's `layout.time_slice_words`.  `dirty_capacity` bounds the
    pages one step may touch, so the flush footprint is bounded by
    window x capacity (past the hybrid threshold the flush goes bulk).
    """

    def __init__(self, protector: Protector, *, window: int = 16,
                 dirty_capacity: Optional[int] = None,
                 dirty_leaf_idx: Optional[Sequence[int]] = None,
                 replicate_meta: bool = False):
        mode = protector.mode
        if not (mode.has_parity or mode.has_cksums):
            raise ValueError(
                "deferred epochs batch parity/checksum work; mode "
                f"{mode.value} has neither — use Protector.commit directly")
        if window < 1:
            raise ValueError(f"window={window}: at least one commit")
        self.p = protector
        # `window` is the ceiling; the current window adapts (see
        # report_pressure)
        self.max_window = window
        self.window = window
        self.metrics = None           # the Pool assigns its registry here
        self.replicate_meta = bool(replicate_meta)
        self._meta: Optional[tuple] = None
        # on a split zone: (this step's digest, the zone's digest table)
        # gathered for the log, which the mirror reuses for that digest
        self._gathered: Optional[tuple] = None
        lo = protector.layout
        self.patch = dirty_leaf_idx is not None
        self.dirty_leaf_idx = (tuple(int(i) for i in dirty_leaf_idx)
                               if self.patch else None)
        if self.patch:
            # every dirty word lies in a dirty leaf (+1 page of word-overhang
            # spill each), and W x a known per-step capacity bounds it too
            leaf_bound = sum(len(layout_mod.leaf_pages(lo, i)) + 1
                             for i in self.dirty_leaf_idx)
            per_step = (int(dirty_capacity) + len(self.dirty_leaf_idx)
                        if dirty_capacity is not None else leaf_bound)
            self.dirty_capacity = min(lo.n_blocks, per_step)
            self.flush_capacity = min(lo.n_blocks, leaf_bound,
                                      per_step * window)
        else:
            if dirty_capacity is not None:
                raise ValueError("dirty_capacity implies a patch engine: "
                                 "pass dirty_leaf_idx")
            self.dirty_capacity = None
            self.flush_capacity = lo.n_blocks
        self.flush_patch = (self.patch
                            and self.flush_capacity / lo.n_blocks
                            < protector.hybrid_threshold)
        # a step's pages past `dirty_capacity` would overflow the flush's
        # page slots; a commit declaring more is refused
        self._capped = self.patch and self.dirty_capacity < min(
            lo.n_blocks, leaf_bound)
        self._leaf_pages = (tuple(len(layout_mod.leaf_pages(lo, i))
                                  for i in self.dirty_leaf_idx)
                            if self.patch else ())
        self._since = 0
        self._step = self.make_step_commit()
        self._step_staged = self.make_step_commit_staged()
        self._flush = self.make_flush()
        # fault-arrival point: fn(est, since, at_boundary) ->
        # Optional[EpochState], called after each commit's bookkeeping and
        # before a due boundary flush; a returned state replaces the window
        self.arrival_hook = None

    # -- lifecycle -------------------------------------------------------------

    def wrap(self, prot: ProtectedState) -> EpochState:
        """Wrap a state whose redundancy is current (after
        `Protector.init`, a flush or a recovery) in an empty window."""
        self._since = 0
        lo, shape = self.p.layout, self.p.mesh.local_dims
        dev = prot.step.device
        return EpochState(
            prot=prot,
            dirty=(torch.zeros(*shape, lo.n_blocks, dtype=torch.bool,
                               device=dev) if self.patch else None),
            pending=torch.zeros((), dtype=utils.WORD, device=dev),
            acc=(None if self.patch else
                 torch.zeros(*shape, lo.row_words, dtype=utils.WORD,
                             device=dev)),
            live=prot.row.clone() if self.patch else None)

    def init(self, state) -> EpochState:
        return self.wrap(self.p.init(state))

    def resume(self, est: EpochState) -> EpochState:
        """Adopt a window opened elsewhere (`convert.to_port_epoch`): the
        host cadence continues from its pending count (one host read).
        A patch window's live row is the epoch-start row with the state
        spliced in."""
        self._since = int(est.pending) & 0xFFFFFFFF
        if self.patch and est.live is None:
            est = dataclasses.replace(est, live=layout_mod.update_row(
                self.p.layout, est.prot.row, est.prot.state,
                self.dirty_leaf_idx))
        return est

    @property
    def needs_flush(self) -> bool:
        return self._since > 0

    # -- adaptive window ---------------------------------------------------------

    def report_pressure(self, suspect: bool) -> int:
        """Feed scrub pressure or failure suspicion back into the window:
        any error collapses it to 1 (the synchronous cadence), every clean
        signal doubles it back toward the ceiling.  Returns the new window;
        it takes effect at the next commit.  On a split zone each signal
        must be one that every process holds alike (an agreed scrub
        report, a recovery, the straggler policy's global durations, a
        global canary), or the processes' windows part and one flushes
        alone, waiting in an exchange its peers never enter."""
        before = self.window
        if suspect:
            self.window = 1
        else:
            self.window = min(self.max_window, max(self.window * 2, 2))
        if self.metrics is not None:
            self.metrics.gauge("pool_window").set(self.window)
            if self.window < before:
                self.metrics.counter("pool_window_collapse_total").inc()
            elif self.window > before:
                self.metrics.counter("pool_window_grow_total").inc()
        return self.window

    # -- replicated window metadata ------------------------------------------------

    @property
    def window_meta(self) -> Optional[dict]:
        """The last mirrored (digest, step, pending, dirty) snapshot on the
        host, or None; read lazily, when a failure consults it."""
        if self._meta is None:
            return None
        nb = self.p.layout.n_blocks
        dig, step, pending, dirty = self._meta
        meta = {"step": int(step) & 0xFFFFFFFF,
                "pending": int(pending) & 0xFFFFFFFF,
                "digest": dig.cpu().numpy().view(np.uint32).copy()}
        if dirty is not None:
            d = dirty.reshape(-1, nb).any(dim=0)
            meta["dirty_pages"] = torch.nonzero(d).reshape(-1).tolist()
        else:
            meta["dirty_pages"] = None     # bulk engine: whole row in-window
        return meta

    def _mirror_meta(self, est: EpochState) -> None:
        """Mirror the window's bookkeeping (a few hundred bytes a commit):
        every rank's row digest, the step, the pending count and the dirty
        mask, so the survivors of a mid-window loss can bound the window.
        Detached copies, queued on the stream (`coll.make_meta_mirror`).
        On a split zone the digests and the dirty mask are the whole
        zone's, gathered from every process; the digest table that the
        step gathered for the log is reused while it is still the window's
        digest (an arrival hook or a staged select may replace it)."""
        p = self.p
        mirror = coll.make_meta_mirror(p.data_dim, p.group)
        gathered, self._gathered = self._gathered, None
        if gathered is not None and gathered[0] is est.prot.digest:
            self._meta = (gathered[1], *mirror(
                (est.prot.step, est.pending, est.dirty)))
        else:
            self._meta = mirror(
                (est.prot.digest, est.prot.step, est.pending, est.dirty))

    def verify_window_bound(self, est: EpochState) -> Optional[bool]:
        """After flush (+ recovery): do the live rows' digests equal the
        mirrored ones?  True means the survivors' metadata bounds the pool
        exactly, with no checkpoint + log replay.  On a split zone each
        process compares its block with its block of the mirror, and the
        verdict is agreed."""
        if self._meta is None:
            return None
        p, lo = self.p, self.p.layout
        dig = ck.digest(layout_mod.flatten_row(lo, est.prot.state),
                        lo.block_words)
        want = self._meta[0]
        if p.group is None:
            return bool(torch.equal(dig, want))
        mesh = p.mesh
        want = want.narrow(p.data_dim, mesh.data_offset,
                           mesh.local_group_size)
        return p.group.agree(torch.equal(dig, want))

    def _log_digest(self, digest: torch.Tensor) -> torch.Tensor:
        """The digest the redo log takes: mesh coordinate 0's, on every
        process.  On a split zone with the meta mirror on, the whole
        zone's table is gathered (the mirror's exchange, kept for it);
        without it, only coordinate 0's 8 bytes."""
        p = self.p
        n_axes = len(p.mesh.shape)
        if p.group is None or not self.replicate_meta:
            return p._first_of_zone(digest, n_axes)
        table = p.group.gather_dim(digest, p.data_dim)
        self._gathered = (digest, table)
        return p._first(table, n_axes)

    # -- in-window commit ------------------------------------------------------

    def make_step_commit(self):
        """Build the in-window commit.  Patch engine: digest over the
        modified words + dirty union + log.  Bulk engine: one accumulate
        sweep (streamed past the protector's threshold) + log."""
        p, lo = self.p, self.p.layout
        mode, bw = p.mode, lo.block_words
        nb, rw = lo.n_blocks, lo.row_words
        patch = self.patch
        dirty_leaves = self.dirty_leaf_idx
        scb = None if patch else p.stream_chunk()
        leaf_pages = ({li: layout_mod.leaf_pages(lo, li)
                       for li in dirty_leaves} if patch else None)

        def _patch_step(digest, dirty, live, state_old, state_new, widx,
                        keep):
            old_leaves = utils.tree_leaves(state_old)
            new_leaves = utils.tree_leaves(state_new)
            dev = digest.device
            # a scratch column at index nb takes the pages past the row
            # end (the reference's scatter mode="drop")
            mask = torch.nn.functional.pad(dirty, (0, 1))
            for k, li in enumerate(dirty_leaves):
                slot = lo.slots[li]
                leaf_o, leaf_n = old_leaves[li], new_leaves[li]
                batch = leaf_o.dim() - len(slot.shape)
                ow = utils.to_words(leaf_o, batch_dims=batch)
                nw = utils.to_words(leaf_n, batch_dims=batch)
                wi = widx[k] if widx is not None else None
                if wi is None:                  # the whole leaf is dirty
                    off = slot.offset + torch.arange(slot.n_words,
                                                     device=dev)
                    o_g, n_g = ow, nw
                    pg = utils.to_device(leaf_pages[li], dev)
                    seg = live[..., slot.offset:slot.offset + slot.n_words]
                    seg.copy_(nw if keep is None
                              else torch.where(keep, nw, seg))
                else:
                    wi, inb = _word_index(wi, slot.n_words, dev)
                    at = wi.clamp(max=slot.n_words - 1)
                    o_g = torch.where(inb, ow[..., at], 0)
                    n_g = torch.where(inb, nw[..., at], 0)
                    off = slot.offset + wi
                    pg = (slot.offset + wi) // bw
                    # an index past the leaf writes its last word, which
                    # the live row takes from the new state all the same
                    at_row = slot.offset + at
                    live[..., at_row] = (nw[..., at] if keep is None else
                                         torch.where(keep, nw[..., at],
                                                     live[..., at_row]))
                digest = ck.update_digest_words(digest, o_g, n_g, off, rw)
                mask[..., pg.clamp(max=nb)] = True
            return digest, mask[..., :nb]

        def _bulk_step(acc, row_cache, state_new):
            # row_cache is last step's row, so the sweep's delta telescopes
            # into acc; its new-page terms serve the table and the digest
            row_new = layout_mod.flatten_row(lo, state_new)
            old_v = parity_mod.page_view(row_cache, bw)
            new_v = parity_mod.page_view(row_new, bw)
            acc_v = parity_mod.page_view(acc, bw)
            if scb is None:
                acc_v, _, new_ck = kops.fused_accum_commit(acc_v, old_v,
                                                           new_v)
                digest = ck.combine(new_ck, bw)
            else:
                acc_v, _, new_ck, digest = kops.fused_accum_commit_stream(
                    acc_v, old_v, new_v)
            return acc_v.reshape(acc.shape), row_new, new_ck, digest

        def commit(prot: ProtectedState, dirty, pending, acc, live,
                   state_new, dirty_words, data_cursor, rng_key, canary_ok,
                   keep=None):
            # canary_ok is host-known: an abort is a no-op that leaves the
            # window, the log included, untouched.  `keep`: the staged
            # canary, which the live row's in-place writes select on
            if not canary_ok:
                return (prot, dirty, pending, acc, live,
                        torch.zeros((), dtype=torch.bool,
                                    device=prot.step.device))
            _check_like(state_new, prot.state)
            step = prot.step + 1
            row, cksums = prot.row, prot.cksums
            if patch:
                digest, dirty = _patch_step(prot.digest, dirty, live,
                                            prot.state, state_new,
                                            dirty_words, keep)
            else:
                acc, row, new_ck, digest = _bulk_step(acc, prot.row,
                                                      state_new)
                if mode.has_cksums:
                    cksums = new_ck
            # the redo record persists per step with the post-step digest;
            # only the parity/checksum refresh is deferred to the flush
            log = prot.log
            if mode.has_log:
                log = redolog.append(
                    log, step, data_cursor,
                    (0, 0) if rng_key is None else rng_key,
                    self._log_digest(digest))
                log = redolog.commit_mark(log, step)
            new_prot = ProtectedState(
                state=state_new, synd=prot.synd, cksums=cksums,
                digest=digest, replica=prot.replica, log=log, step=step,
                row=row)
            return (new_prot, dirty, pending + 1, acc, live,
                    torch.ones((), dtype=torch.bool,
                               device=prot.step.device))

        return commit

    def make_step_commit_staged(self):
        """The in-window commit with the canary verdict on the device (a 0-d
        bool the host has not read, e.g. `ops.stage_verdict` over guarded
        staging buffers).  The all-clear step runs unconditionally; then
        every output is selected against the previous (prot, dirty,
        pending, acc) on the canary, so a False canary leaves the window,
        the redo log included, exactly as the host-known abort does; the
        live row's writes select on it in place.  On a split zone the
        canary is agreed first (the AND across the processes, the
        reference's `pmin`): one process's smashed canary aborts the
        commit on every process."""
        inner = self._step
        group = self.p.group

        def commit(prot: ProtectedState, dirty, pending, acc, live,
                   state_new, dirty_words, data_cursor, rng_key, canary):
            v = device_bool(canary, prot.step.device)
            if group is not None:
                v = group.all_and(v)
            new = inner(prot, dirty, pending, acc, live, state_new,
                        dirty_words, data_cursor, rng_key, True, keep=v)
            return (*tree_select(v, new[:4], (prot, dirty, pending, acc)),
                    live, v)

        return commit

    # -- epoch flush -----------------------------------------------------------

    def make_flush(self):
        """Build the once-per-epoch refresh.  Patch engine: take the live
        row (never the state, which a fault may have damaged); patch the dirty pages' weighted deltas
        into the stack (+ their fresh terms), or rebuild both from the
        spliced row past the hybrid threshold.  Bulk engine: weight the
        accumulator into the r planes and fold them into the stack."""
        p, lo = self.p, self.p.layout
        mode, bw, dd = p.mode, lo.block_words, p.data_dim
        nb, kf = lo.n_blocks, self.flush_capacity
        fpatch, patch = self.flush_patch, self.patch
        shape, group = p.mesh.local_dims, p.group

        def _patch_pages(base, row, synd, cksums, dirty, coeffs):
            """The window's dirty pages, at most kf (`dirty_slots`), the
            fill slots at the sentinel nb.  Every device's mask is the same
            (the word indices are replicated), so the union is each one's;
            on a split zone every process's is the same too, and the union
            needs no exchange."""
            sidx, valid = dirty_slots(dirty.reshape(-1, nb).any(dim=0), kf)
            g = sidx.clamp(max=nb - 1)
            old_p = parity_mod.gather_pages(base, g, bw)      # (*M, kf, bw)
            new_p = parity_mod.gather_pages(row, g, bw)
            if mode.has_cksums:
                # every syndrome rides the window's telescoped delta
                sdelta_p, fresh = kops.fused_commit_s(old_p, new_p, coeffs)
                padded = torch.cat(
                    [cksums, cksums.new_zeros(*shape, 1, 2)], dim=-2)
                padded[..., sidx, :] = fresh
                cksums = padded[..., :nb, :]
            else:
                delta_p = kops.xor_delta(old_p, new_p)
                sdelta_p = kops.syndrome_scale(
                    delta_p.reshape(*shape, kf * bw), coeffs).reshape(
                        *shape, -1, kf, bw)
            if mode.has_parity:
                sdelta_p = torch.where(valid[:, None], sdelta_p, 0)
                # fill slots go to the sentinel, not the clamped page: a
                # clamped fill would collide with a dirty last page
                synd = parity_mod.patch_syndrome_delta(synd, sdelta_p, sidx,
                                                       lo, dd, group)
            return synd, cksums

        def flush(est: EpochState) -> EpochState:
            prot = est.prot
            base, synd, cksums, acc = prot.row, prot.synd, prot.cksums, \
                est.acc
            coeffs = p.coeffs(base.device) if mode.has_parity else None
            # the live row goes on taking the next window's writes
            row = est.live.clone() if patch else base
            if fpatch:
                synd, cksums = _patch_pages(base, row, synd, cksums,
                                            est.dirty, coeffs)
            elif patch:
                # past the hybrid threshold: rebuild from the spliced row,
                # equal to the patched stack by XOR linearity
                if mode.has_parity:
                    synd = parity_mod.build_syndromes(row, dd, coeffs,
                                                      group)
                if mode.has_cksums:
                    cksums = kops.fletcher_blocks(
                        parity_mod.page_view(row, bw))
            else:
                # acc == row_start ^ row_now, so S_k ^ rs(g^(k·me)·acc) is
                # the stack rebuilt from the current row; the checksums are
                # already fresh from the accumulate steps
                if mode.has_parity:
                    synd = synd ^ parity_mod.build_syndromes(acc, dd, coeffs,
                                                             group)
                acc = torch.zeros_like(acc)
            dirty = (torch.zeros_like(est.dirty) if est.dirty is not None
                     else None)
            return EpochState(
                prot=dataclasses.replace(prot, synd=synd, cksums=cksums,
                                         row=row),
                dirty=dirty, pending=torch.zeros_like(est.pending), acc=acc,
                live=est.live)

        return flush

    # -- entry points ----------------------------------------------------------

    def _declared_pages(self, dirty_words) -> int:
        """The pages a patch commit's footprint names, leaf by leaf (a
        page two leaves share counted for each); a word index past its
        leaf names none (`_word_index`)."""
        if dirty_words is None:
            return sum(self._leaf_pages)
        lo = self.p.layout
        n = 0
        for li, w, whole in zip(self.dirty_leaf_idx, dirty_words,
                                self._leaf_pages):
            if w is None:
                n += whole
                continue
            slot = lo.slots[li]
            w = np.asarray(w.cpu() if isinstance(w, torch.Tensor) else w,
                           np.int64).reshape(-1)
            w = w[w < slot.n_words]
            first = slot.offset // lo.block_words
            seen = np.zeros(whole, bool)
            seen[(slot.offset + w) // lo.block_words - first] = True
            n += int(np.count_nonzero(seen))
        return n

    def _check_footprint(self, dirty_words) -> None:
        """Refuse a patch commit that declares more than `dirty_capacity`
        pages: the flush gathers at most `flush_capacity` dirty pages, so
        the pages past it would miss the stack and the checksums (the
        reference's flush keeps the first ones and drops the rest: ROADMAP
        queue C)."""
        if not self._capped:
            return
        n = self._declared_pages(dirty_words)
        if n > self.dirty_capacity:
            raise ValueError(
                f"the footprint names {n} pages, past the "
                f"{self.dirty_capacity} a commit of this patch engine may "
                "touch: its flush would drop the rest; open the pool "
                "again over the state (Pool.init) instead")

    def _check_dirty_words(self, dirty_words) -> None:
        if dirty_words is not None and (
                not self.patch
                or len(dirty_words) != len(self.dirty_leaf_idx)):
            raise ValueError("dirty_words needs a patch engine, one entry "
                             "per leaf of dirty_leaf_idx")
        if self.patch:
            self._check_footprint(dirty_words)

    def commit(self, est: EpochState, state_new, *, dirty_words=None,
               data_cursor=0, rng_key=None, canary_ok: bool = True):
        """One transactional update of zone-stacked `state_new`; flushes
        automatically at the window boundary.  `dirty_words` (patch
        engines): a tuple aligned with `dirty_leaf_idx` of per-leaf
        word-index arrays, or None entries (or None for the whole tuple)
        for wholly dirty leaves, naming at most `dirty_capacity` pages.
        Returns (successor, ok) with `ok` a 0-d bool tensor."""
        self._check_dirty_words(dirty_words)
        prot, dirty, pending, acc, live, ok = self._step(
            est.prot, est.dirty, est.pending, est.acc, est.live, state_new,
            dirty_words, data_cursor, rng_key, bool(canary_ok))
        est = EpochState(prot=prot, dirty=dirty, pending=pending, acc=acc,
                         live=live)
        return self._after_step(est), ok

    def commit_staged(self, est: EpochState, state_new, *, canary,
                      dirty_words=None, data_cursor=0, rng_key=None):
        """`commit` with the canary verdict on the device (`canary`, a 0-d
        bool tensor; see `make_step_commit_staged`).  Nothing waits for it:
        the returned `ok` is the canary itself, still unread.  The host
        cadence (`_since`, the boundary flush) counts the attempt exactly
        as the host-known path does, so a drained pipeline holds what
        resolving each commit at once would."""
        self._check_dirty_words(dirty_words)
        prot, dirty, pending, acc, live, ok = self._step_staged(
            est.prot, est.dirty, est.pending, est.acc, est.live, state_new,
            dirty_words, data_cursor, rng_key, canary)
        est = EpochState(prot=prot, dirty=dirty, pending=pending, acc=acc,
                         live=live)
        return self._after_step(est), ok

    def _after_step(self, est: EpochState) -> EpochState:
        """Post-commit host cadence: the attempt count (aborts count too),
        the fault-arrival hook, the boundary flush, the meta mirror."""
        due = self.count_attempt()
        if self.arrival_hook is not None:
            replaced = self.arrival_hook(est, self._since, due)
            if replaced is not None:
                est = replaced
        if due:
            est = self.flush(est)
        self.mirror(est)
        return est

    def count_attempt(self) -> bool:
        """Count one commit attempt (an abort counts too); True when the
        window has come due and the caller must flush."""
        self._since += 1
        return self._since >= self.window

    def note_flush(self) -> None:
        """A flush's host bookkeeping: the window's cadence restarts and
        the metrics record the commits it closes."""
        pending = self._since
        self._since = 0
        if self.metrics is not None:
            self.metrics.counter("pool_window_flush_total").inc()
            self.metrics.histogram("pool_flush_pending").observe(pending)

    def mirror(self, est: EpochState) -> None:
        """The end of a step: mirror the window meta when replicated."""
        if self.replicate_meta:
            self._mirror_meta(est)

    def flush(self, est: EpochState) -> EpochState:
        """Refresh the stack and checksums (and the row) from the window."""
        self.note_flush()
        return self._flush(est)

    def flush_if_pending(self, est: EpochState) -> EpochState:
        """Flush only when in-window work exists (pre-scrub / recovery)."""
        return self.flush(est) if self.needs_flush else est
