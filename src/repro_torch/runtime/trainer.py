"""Fault-tolerant training loop: Pangolin transactions around train steps
(the reference's runtime/trainer.py).

Per step:  batch <- deterministic pipeline(cursor)
           micro-buffer   = train_step(state, batch)      (pure staging)
           commit         = canary check -> redo record -> protection ->
                            functional swap
           scrub every N commits; online recovery on failure events;
           async disk checkpoints as the backstop tier.

All protection plumbing lives in the `Pool` facade (repro_torch/pool.py):
the trainer opens one cold pool over the train state's layout from its
`ProtectConfig` and routes every commit, scrub and recovery through it.
The config's `window` selects the engine (1 = synchronous, W > 1 =
deferred epochs whose redo log still persists per step);
`scrub_period` drives `pool.maybe_scrub()`; faults funnel through
`pool.recover(Fault...)`.  Each step reads the state from the pool
(`pool.state`, the global view) and hands the new state to
`commit_async`, which shards it again (`Pool.to_zone`).

On a mesh split over W processes (dist/procs.py) the step is data
parallel and byte-equal to the one-process step at the same
`TrainConfig.microbatches`, which W must divide
(`api.split_train_step`): each process reads its block of the state
(no gathered `pool.state`), gathers the parameters, computes its
microbatches' gradients, folds every gradient in microbatch order with
the others, updates its block and commits it (`block=True`).  Every
process calls the same methods with the same arguments; the host cadence
reads agreed values only (the verdict, the folded loss, the straggler's
per-replica step times, which are process 0's: `agreed_times`).
`save_checkpoint` gathers the global state on every process and process
0 writes it, in the one-process format; `restore_from_checkpoint` reads
it on every process after process 0's write has landed, so checkpoints
move between a split and a one-process trainer both ways.  Replay runs
on every process and checks the digest at mesh coordinate 0.

`run` keeps up to `pipeline_depth` steps dispatched with unresolved
verdicts (the commit ring; `overlap_commit` folds into depth 2); an
explicit `step()` resolves at once.  The train step itself reads nothing
back to the host: the host waits only where the reference's does, for
the verdict and the loss in `_resolve_step` and in `save_checkpoint`.

Crash recovery (paper §3.6): restore the newest checkpoint, then replay
the redo log's marked records — the deterministic pipeline regenerates
each logged batch from its cursor, and the row digest checks that each
replayed step landed on the logged bytes.  The train step gives the same
bits on every run (layers.row_sums), which replay needs.  The trainer
runs on the card unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import obs, utils
from repro_torch.configs.base import ModelConfig, ProtectConfig, TrainConfig
from repro_torch.core import redolog
from repro_torch.data.synthetic import batch_for
from repro_torch.models import api
from repro_torch.models.transformer import build_model
from repro_torch.optim import build_optimizer
from repro_torch.pool import Fault, Pool, PoolHost


class Trainer(PoolHost):
    def __init__(self, cfg: ModelConfig, train_cfg: TrainConfig,
                 protect_cfg: ProtectConfig, mesh, *,
                 seq_len: int = 128, global_batch: int = 8,
                 checkpoint_dir: Optional[str] = None, seed: int = 0,
                 metrics_dir: Optional[str] = None,
                 trace_dir: Optional[str] = None,
                 metrics_every: int = 25, device=None):
        self.cfg = cfg
        self.train_cfg = train_cfg
        self.mesh = mesh
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.device = utils.resolve_device(device)
        self.overlap_commit = bool(protect_cfg.overlap_commit)
        self.window = int(protect_cfg.window)
        # overlap_commit is the legacy one-behind pipeline; it folds into
        # the commit ring as an effective depth of 2
        depth = int(protect_cfg.pipeline_depth)
        if self.overlap_commit and depth < 2:
            depth = 2
            protect_cfg = dataclasses.replace(protect_cfg,
                                              pipeline_depth=depth)
        self.pipeline_depth = depth
        self.protect_cfg = protect_cfg

        self.model = build_model(cfg, mesh)
        self.optimizer = build_optimizer(train_cfg, cfg)
        self.stream = batch_for(cfg, seq_len, global_batch, seed)

        abstract_state = api.abstract_train_state(self.model, self.optimizer)
        self.state_specs = api.train_state_specs(self.model, self.optimizer,
                                                 mesh)
        # telemetry: --trace-dir gives the pool a file-backed tracer;
        # --metrics-dir makes the step loop publish the registry + stats
        # snapshot every `metrics_every` resolved steps
        self.metrics_dir = metrics_dir
        self.metrics_every = max(1, int(metrics_every))
        tracer = None
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            tracer = obs.Tracer(os.path.join(
                trace_dir, "trainer.trace.jsonl" if mesh.world == 1
                else f"trainer.p{mesh.proc_rank}.trace.jsonl"))
        self.pool = Pool(mesh, abstract_state, self.state_specs, protect_cfg,
                         device=self.device, on_freeze=self.freeze,
                         on_resume=self.resume, tracer=tracer)

        self._train_step = api.make_train_step(
            self.model, self.optimizer, train_cfg, mesh, self.state_specs)
        self.checkpoint_dir = checkpoint_dir
        self._ckpt_mgr = None
        if checkpoint_dir:
            from repro_torch.checkpoint.manager import CheckpointManager
            self._ckpt_mgr = CheckpointManager(
                checkpoint_dir, mesh, self.state_specs, device=self.device)
        self.cursor = 0
        self.history: list = []
        self._frozen = False
        self._host_step = 0
        # hooks fired after every resolved step with the step's summary
        # dict (chaos schedule attachment, tracing)
        self._step_hooks: list = []
        # per-replica step-time dilation fed to the straggler policy when
        # ProtectConfig.straggler_threshold wires one into the pool; the
        # chaos runner (and tests) dilate entries to simulate a slow
        # replica without sleeping per rank
        self.replica_slowdown = np.ones(self.pool.protector.group_size)
        # verify-at-open (the paper's default policy): checksums of the old
        # state verified inside every synchronous commit, abort on mismatch
        self.verify_old = False

    # -- lifecycle ---------------------------------------------------------------

    def initialize(self, gen: Optional[torch.Generator] = None,
                   params: Optional[dict] = None) -> None:
        """Open protection over a fresh train state: `params` on the
        trainer's device, else random parameters from `gen`, by default a
        generator on the trainer's device seeded with `seed`."""
        if params is None and gen is None:
            gen = torch.Generator(self.device).manual_seed(self.seed)
        self.pool.init(api.init_train_state(self.model, self.optimizer, gen,
                                            self.device, params=params))
        self._host_step = 0

    def freeze(self):
        """Paper's pool freeze: drain outstanding work before recovery."""
        self._frozen = True
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def resume(self):
        self._frozen = False

    # -- stepping ----------------------------------------------------------------

    def _dispatch_step(self, *, canary_ok: bool = True) -> dict:
        """Dispatch compute + commit without a host synchronization; returns
        the pending record `_resolve_step` finishes."""
        assert self.prot is not None and not self._frozen
        t0 = time.perf_counter()
        batch = self.stream.device_batch(self.cursor, self.device)
        if self.pool.dropped_replicas:
            # straggler mitigation: zero the dropped replicas' examples
            # out of the loss (replica-major layout)
            batch["loss_mask"] = utils.to_device(
                self.pool.straggler.loss_mask(self.global_batch),
                self.device)
        rng = utils.fold_in(utils.prng_key(self.seed), self.cursor)
        cursor_before = self.cursor
        split = self.mesh.group is not None
        new_state, metrics = self._train_step(
            self.pool.prot.state if split else self.pool.state, batch)
        ticket = self.pool.commit_async(new_state, data_cursor=self.cursor,
                                        rng_key=rng, canary_ok=canary_ok,
                                        verify_old=self.verify_old,
                                        block=split)
        self.cursor += 1          # optimistic; rolled back on an abort
        return {"ticket": ticket, "loss": metrics["loss"],
                "cursor_before": cursor_before, "t0": t0}

    def _resolve_step(self, pending: dict) -> dict:
        """Await a dispatched step's commit; bookkeeping + scrub cadence."""
        committed = bool(pending["ticket"].result())
        if committed:
            self._host_step += 1
        else:
            self.cursor = pending["cursor_before"]
        out = {"step": self._host_step, "loss": float(pending["loss"]),
               "committed": committed}
        if self.pool.straggler is not None:
            # one wall-clock measurement a step, dilated per replica
            dropped = self.pool.observe_commit_times(self.agreed_times(
                (time.perf_counter() - pending["t0"])
                * self.replica_slowdown))
            if not dropped.all():
                out["dropped_replicas"] = sorted(self.pool.dropped_replicas)
        self.history.append(out)
        report = self.pool.maybe_scrub()
        if report is not None:
            out["scrub"] = dataclasses.asdict(report)
        # the loss and the verdict were fetched above, so publishing them
        # costs no extra sync
        reg = self.pool.metrics
        reg.counter("trainer_steps_total").inc()
        if not committed:
            reg.counter("trainer_aborted_steps_total").inc()
        reg.gauge("trainer_loss").set(out["loss"])
        reg.histogram("trainer_step_wall_ms").observe(
            (time.perf_counter() - pending["t0"]) * 1e3)
        if (self.metrics_dir and self.mesh.proc_rank == 0
                and self._host_step % self.metrics_every == 0):
            obs.write_metrics(reg, self.metrics_dir, prefix="trainer",
                              stats=self.pool.stats())
        for hook in list(self._step_hooks):
            hook(self, out)
        return out

    def agreed_times(self, times: np.ndarray) -> np.ndarray:
        """The per-replica step times the straggler policy reads: on a
        split mesh process 0's (its clock and its `replica_slowdown`), so
        that every process drops the same replicas and masks the same
        rows."""
        if self.mesh.group is None:
            return times
        return self.mesh.group.all_gather(torch.as_tensor(
            times, dtype=torch.float64))[0].numpy()

    def add_step_hook(self, fn) -> None:
        """Register `fn(trainer, out_dict)`, fired after every resolved
        step — the chaos campaign's schedule attachment point."""
        self._step_hooks.append(fn)

    def step(self, *, canary_ok: bool = True) -> dict:
        return self._resolve_step(self._dispatch_step(canary_ok=canary_ok))

    def run(self, n_steps: int, checkpoint_every: int = 0) -> list:
        """The training loop on the commit ring: up to `pipeline_depth`
        steps stay dispatched-but-unresolved (compute t+k is enqueued
        before commit t's verdict is fetched).  Depth 1 resolves every step
        inline; the trailing in-flight steps drain at the end, so a `run`
        boundary is always fully resolved."""
        def maybe_checkpoint():
            if (outs and checkpoint_every and self._ckpt_mgr
                    and outs[-1]["step"] % checkpoint_every == 0
                    and outs[-1]["committed"]):
                self.save_checkpoint()

        outs = []
        pending: list = []
        for _ in range(n_steps):
            if self.pipeline_depth > 1:
                pending.append(self._dispatch_step())
                if len(pending) >= self.pipeline_depth:
                    outs.append(self._resolve_step(pending.pop(0)))
            else:
                outs.append(self.step())
            maybe_checkpoint()
        while pending:
            # the trailing pipelined steps get the checkpoint cadence the
            # synchronous path would give them
            outs.append(self._resolve_step(pending.pop(0)))
            maybe_checkpoint()
        return outs

    # -- fault handling -----------------------------------------------------------

    def on_failure(self, event) -> dict:
        """Online recovery entry point (the SIGBUS-handler analogue):
        `Pool.recover` owns the whole sequence."""
        assert self.prot is not None
        rep = self.pool.recover(Fault.from_event(event))
        if rep is None:
            # a recovery was already in flight; this fault was queued and
            # drains right after it
            return {"queued": True}
        return dataclasses.asdict(rep)

    # -- checkpoint / crash recovery ------------------------------------------------

    def save_checkpoint(self, wait: bool = False) -> None:
        """Save the global state, the cursor and the redo log (the state is
        copied to the host before this returns; the write runs on the
        manager's thread unless `wait`).  On a split mesh every process
        gathers the state (a collective) and process 0 writes it."""
        assert self._ckpt_mgr is not None and self.prot is not None
        state = self.pool.state
        if self.mesh.proc_rank == 0:
            self._ckpt_mgr.save(self.pool.step, state,
                                extra={"cursor": self.cursor,
                                       "log": self.prot.log})
        del state
        if wait:
            self._ckpt_mgr.wait()

    def restore_from_checkpoint(self, replay: bool = True,
                                log: Optional[redolog.RedoLog] = None
                                ) -> dict:
        """Crash recovery: the newest checkpoint + redo-log replay (§3.6).

        The replay reads the checkpoint's own log unless `log` hands in
        the surviving redo log (kept in a peer's memory in production):
        the records logged after the checkpoint are what replay re-runs.
        Every replayed step's digest must equal its record's."""
        from repro_torch.checkpoint.manager import log_from_extra
        assert self._ckpt_mgr is not None
        self._ckpt_mgr.wait()
        if self.mesh.group is not None:
            self.mesh.group.barrier()      # process 0's write has landed
        step, state, extra = self._ckpt_mgr.restore_latest()
        prot = self.protector.init(self.pool.to_zone(state))
        self.prot = dataclasses.replace(prot, step=torch.full(
            (), utils.word(step), dtype=utils.WORD, device=self.device))
        del state, prot            # the replay below must not keep them
        self._host_step = int(step)
        self.cursor = int(extra.get("cursor", step))
        replayed = []
        log = log if log is not None else extra.get("log")
        if replay and log is not None:
            log = log_from_extra(log, self.device)
            for s in redolog.replayable_steps(log, step):
                rec = redolog.lookup(log, s)
                self.cursor = int(utils.as_u64(rec["data_cursor"]))
                out = self.step()
                replayed.append(out["step"])
                # the replayed step must reproduce the logged digest (mesh
                # coordinate 0's, on every process)
                if self.prot.digest is not None:
                    dig = self.protector._first_of_zone(
                        self.prot.digest, len(self.mesh.shape))
                    if not torch.equal(dig, rec["digest"]):
                        raise RuntimeError(
                            f"replay digest mismatch at step {s}")
        return {"restored_step": step, "replayed": replayed}
