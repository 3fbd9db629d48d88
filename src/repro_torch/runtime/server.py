"""Serving runtime: batched greedy decode with Pangolin protection of the
KV cache (the reference's runtime/server.py).

Decode is the paper's small atomic update: each step writes one time slot
of every cache leaf.  The dirty footprint of a step is computed from the
cache layout on the host (`layout.time_slice_pages`: the page columns
under time slot `pos` of every leaf), so a decode commit takes the patch
path.  The server opens one cold `Pool` over the cache layout and hands it
the footprint its engine takes: `dirty_pages` on the synchronous engine
(`window=1`), `dirty_words` (`layout.time_slice_words`) on the deferred
engine (`window=W>1`), whose patch engine spans every cache leaf with a
page capacity from `layout.time_slice_page_capacity`.  The rule takes
any local axis of length max_len for time, so a max_len equal to a local
axis of a leaf that has no time axis (an xLSTM head_dim, a conv width)
is refused: it would declare one slot of a leaf rewritten whole.  At
`pipeline_depth > 1` each commit goes through `commit_async` and resolves
as its verdict lands; `generate` drains the ring before it returns.

Each step reads the cache from the pool (`pool.block_state`, the global
view on one process) and hands the pool the step's new cache, which
`Pool.commit` shards again: two copies of the cache a token.  The decode
step builds the new cache in a fresh copy, so a pool-held cache is never
written.

On a mesh split over processes (dist/procs.py) the decode is data
parallel: every process keeps the whole weights, decodes its block's
rows of the batch (the cache's batch is sharded over `data`) against its
block view of the cache, and commits its block; the footprint stays the
global page or word list, whose owners the engines route.  `step` takes
and returns the block's rows; `prefill` and `generate` take the global
`(B, S)` prompt on every process, and `generate` gathers the tokens in
rank order, so every process returns the whole `(B, n_new)` array.  A
batch that G does not divide leaves the cache's batch unsplit (`spec_for`
replicates it), so it cannot be decoded by blocks: refused.

Weights are cast to the compute dtype once, in `start`: the reference
casts them inside every step, to the same bits.  An encoder-decoder's
cache opens with zero cross K/V, as the reference's: `start` encodes no
source.  A caller writes them with one commit of the cache (bulk, on the
synchronous engine); a step's footprint declares a time slot of them,
which the step never writes (the rule above).  The server runs on the
card unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import obs, utils
from repro_torch.configs.base import ModelConfig, ProtectConfig
from repro_torch.core import layout as layout_mod
from repro_torch.dist import sharding
from repro_torch.models import api
from repro_torch.models.transformer import build_model
from repro_torch.obs.trace import layer
from repro_torch.pool import Pool, PoolHost

PyTree = Any


def _state_axis_clashes(lo, cache_abs, shorter, max_len: int) -> list:
    """Local shapes of the cache leaves that do not grow with max_len (the
    same at max_len - 1) yet have a local axis of length max_len, which
    the footprint rule (`layout._slot_time_runs`) would take for time."""
    if max_len < 2:
        return []
    return [tuple(sl.shape) for sl, a, b in zip(
        lo.slots, utils.tree_leaves(cache_abs), utils.tree_leaves(shorter),
        strict=True)
        if a.shape == b.shape and layout_mod._slot_time_runs(sl, max_len)]


class Server(PoolHost):
    def __init__(self, cfg: ModelConfig, protect_cfg: ProtectConfig, mesh,
                 *, batch: int, max_len: int, protect_cache: bool = True,
                 window: Optional[int] = None,
                 metrics_dir: Optional[str] = None,
                 trace_dir: Optional[str] = None,
                 metrics_every: int = 100, device=None):
        if mesh.group is not None and batch % mesh.group_size:
            raise ValueError(
                f"a server split over {mesh.world} processes decodes each "
                f"process's block of the batch, but batch % G = {batch} % "
                f"{mesh.group_size} = {batch % mesh.group_size}: the cache's "
                "batch would not split over the data axis")
        self.cfg = cfg
        self.mesh = mesh
        self.batch = batch
        self.max_len = max_len
        self.device = utils.resolve_device(device)
        self.model = build_model(cfg, mesh)
        # a split server decodes its block: a one-process zone of its own
        block = mesh.block_mesh
        self._decode = api.make_decode_step(
            self.model if block is mesh else build_model(cfg, block))
        rows = sharding.spec_for(mesh, ("batch",), (batch,),
                                 cfg.logical_overrides)
        self._row_spec = sharding.P(rows[0] if rows else None)
        self._cache_specs = self.model.cache_specs(batch, max_len, mesh)
        self.window = int(window if window is not None
                          else protect_cfg.window)

        self.protect_cache = protect_cache and protect_cfg.mode != "none"
        if (self.protect_cache and window is not None
                and window != protect_cfg.window):
            # the override is folded into the config, which stays the one
            # source of truth and validates it (only when a pool is built,
            # so an unprotected server accepts any window)
            protect_cfg = dataclasses.replace(protect_cfg, window=window)
        # commit ring depth: at depth > 1 decode commits go through
        # commit_async; depth 1 resolves each commit before the next step
        self.pipeline_depth = int(protect_cfg.pipeline_depth)
        # telemetry (inert on an unprotected server: no pool)
        self.metrics_dir = metrics_dir
        self.metrics_every = max(1, int(metrics_every))
        tracer = None
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            tracer = obs.Tracer(os.path.join(
                trace_dir, "server.trace.jsonl" if mesh.world == 1
                else f"server.p{mesh.proc_rank}.trace.jsonl"))
        self.pool: Optional[Pool] = None
        if self.protect_cache:
            cache_abs = self.model.init_cache(batch, max_len, device="meta")
            # the deferred engine spans every cache leaf, with the per-step
            # page capacity sized from the layout the pool builds
            self.pool = Pool(
                mesh, cache_abs, self._cache_specs, protect_cfg,
                device=self.device,
                dirty_leaf_idx=(
                    None if self.window == 1
                    else (lambda lo: range(len(lo.slots)))),
                dirty_capacity=(
                    None if self.window == 1
                    else (lambda lo: layout_mod.time_slice_page_capacity(
                        lo, max_len))),
                tracer=tracer)
            clash = _state_axis_clashes(
                self.protector.layout, cache_abs,
                self.model.init_cache(batch, max_len - 1, device="meta"),
                max_len)
            if clash:
                raise ValueError(
                    f"max_len {max_len} is the length of a local axis of "
                    f"the state leaves {clash}, which every step rewrites "
                    "whole: the footprint would take that axis for time "
                    "and declare one slot of them; choose another max_len")
            self._page_cache: dict = {}
            self._word_cache: dict = {}
        # hooks fired after every decode step with {"pos": position}
        self._step_hooks: list = []

    def add_step_hook(self, fn) -> None:
        """Register `fn(server, out_dict)`, fired after every decode step
        (the chaos campaign's schedule attachment point)."""
        self._step_hooks.append(fn)

    # -- decode footprint ---------------------------------------------------------

    def _dirty_pages(self, pos: int) -> list:
        key = pos % self.max_len
        if key not in self._page_cache:
            self._page_cache[key] = layout_mod.time_slice_pages(
                self.protector.layout, self.max_len, key).tolist()
        return self._page_cache[key]

    def _dirty_words(self, pos: int) -> tuple:
        key = pos % self.max_len
        if key not in self._word_cache:
            self._word_cache[key] = tuple(layout_mod.time_slice_words(
                self.protector.layout, self.max_len, key))
        return self._word_cache[key]

    def start(self, params: PyTree) -> None:
        """Take the parameters (cast once to the compute dtype) and open
        protection over an empty cache."""
        self.params = self.model.compute_params(
            utils.tree_map(lambda w: w.to(self.device), params))
        cache = self.model.init_cache(self.batch, self.max_len, self.device)
        if self.pool is not None:
            self.pool.init(cache)
        else:
            self.cache = utils.tree_map(
                lambda x, spec: sharding.block_of(x, spec, self.mesh),
                cache, self._cache_specs)
        self.pos = 0

    def block_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of a global batch-leading tensor (all of
        them on one process)."""
        return sharding.block_of(x, self._row_spec, self.mesh)

    def _current_cache(self):
        return (self.pool.block_state if self.pool is not None
                else self.cache)

    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        """One decode step for this process's rows of the batch (the whole
        batch on one process); returns their next tokens."""
        with layer("serve.step"):
            cache = self._current_cache()
            with layer("serve.decode"):
                next_tok, _, new_cache = self._decode(
                    self.params, tokens, cache, self.pos)
            del cache       # the read view is not held through the commit
            if self.pool is not None:
                # only the built engine's footprint spelling is computed
                with layer("serve.footprint"):
                    fp = (dict(dirty_words=self._dirty_words(self.pos))
                          if self.pool.engine is not None
                          else dict(dirty_pages=self._dirty_pages(self.pos)))
                if self.pipeline_depth > 1:
                    # dispatch and move on; verdicts resolve as they land
                    # (the ring resolves the oldest past its depth) and
                    # `generate` drains at the end
                    self.pool.commit_async(new_cache, block=True, **fp)
                    self.pool.poll()
                else:
                    self.pool.commit(new_cache, block=True, **fp)
                self.pool.maybe_scrub()
                reg = self.pool.metrics
                reg.counter("server_steps_total").inc()
                if (self.metrics_dir and self.mesh.proc_rank == 0
                        and (self.pos + 1) % self.metrics_every == 0):
                    obs.write_metrics(reg, self.metrics_dir,
                                      prefix="server",
                                      stats=self.pool.stats())
            else:
                self.cache = new_cache
            self.pos += 1
            for hook in list(self._step_hooks):
                hook(self, {"pos": self.pos - 1})
            return next_tok

    def prefill(self, prompt: torch.Tensor) -> torch.Tensor:
        """Feed a global prompt (B, S) through decode steps (this process's
        rows of it); returns their last prediction."""
        prompt = self.block_rows(torch.as_tensor(prompt).to(self.device))
        tok = prompt[:, 0]
        for t in range(prompt.shape[1]):
            tok = self.step(prompt[:, t])
        return tok

    def generate(self, prompt: torch.Tensor, n_new: int) -> np.ndarray:
        """Prefill `prompt`, then decode; returns the (B, n_new) tokens
        (the first is prefill's last prediction), gathered in rank order
        from every process of a split mesh."""
        tok = self.prefill(prompt)
        out = [tok]
        for _ in range(n_new - 1):
            tok = self.step(tok)
            out.append(tok)
        if self.pool is not None:
            # a generation boundary is a pipeline boundary: every in-flight
            # commit verdict resolves before the tokens return
            self.pool.drain()
        toks = sharding.gather_global(torch.stack(out, dim=1),
                                      self._row_spec, self.mesh)
        return toks.cpu().numpy()
