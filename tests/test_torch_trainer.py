"""The port's training runtime (repro_torch.runtime.trainer, launch.train,
chaos.attach_schedule on a Trainer) against the reference's Trainer, on
the reduced t_train model of tests/test_trainer.py (2 layers, d_model 32,
f32) over the (4, 2) mesh (the reference's built with Auto axis types).

Each package's float math rounds differently (the train steps agree to
~1e-6, not bit for bit; tests/test_torch_train_model.py holds them to
stated tolerances), so the protected bytes are compared where both see
the same states: the port's trainer starts from the reference's initial
state and its train step returns the reference's outputs, step by step,
after checking that it was handed the reference's input state and batch
(loss mask included) byte for byte.  After every step the two pools are
byte-equal: state, row, syndromes, checksums, digest, redo log (rng
words and cursors included), or the whole open window.  The port's own
train step is held to its own replay: a restored trainer re-runs the
logged steps to the logged digests.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.chaos.runner import attach_schedule as ref_attach
from repro.chaos.schedule import ChaosEvent as RefE
from repro.chaos.schedule import FaultSchedule as RefSchedule
from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import ProtectConfig as RefProtectConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.dist.straggler import StragglerPolicy as RefStraggler
from repro.runtime import failure as ref_failure
from repro.runtime.trainer import Trainer as RefTrainer
from repro_torch import convert, utils
from repro_torch.chaos.runner import attach_schedule
from repro_torch.chaos.schedule import ChaosEvent, FaultSchedule
from repro_torch.configs.base import ModelConfig, ProtectConfig, TrainConfig
from repro_torch.dist.straggler import StragglerPolicy
from repro_torch.launch import train as launch_train
from repro_torch.models import api
from repro_torch.runtime import failure
from repro_torch.runtime.trainer import Trainer
from tests import _torch_ref as tr
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

T_TRAIN = dict(name="t_train", family="dense", n_layers=2, d_model=32,
               n_heads=4, n_kv=2, d_ff=64, vocab=128, param_dtype="float32",
               compute_dtype="float32")
TRAIN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=100)
SEQ, BATCH = 16, 8


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def host_bytes(t):
    return convert._np_leaf(t).tobytes()


class Lockstep:
    """A reference Trainer and a port Trainer over the same mesh shape and
    config (`model`: ModelConfig's fields, t_train unless given), the
    port's train step replaying the reference's."""

    def __init__(self, mode="mlpc", seed=0, ref_dir=None, port_dir=None,
                 model=T_TRAIN, seq=SEQ, train=TRAIN, **pkw):
        self.mesh, self.zmesh = tr.jax_mesh("mesh42"), tr.zone_mesh(
            "mesh42")
        kw = dict(seq_len=seq, global_batch=BATCH, seed=seed)
        self.ref = RefTrainer(
            RefModelConfig(**model), RefTrainConfig(**train),
            RefProtectConfig(mode=mode, block_words=64, **pkw), self.mesh,
            checkpoint_dir=ref_dir, **kw)
        self.port = Trainer(
            ModelConfig(**model), TrainConfig(**train),
            ProtectConfig(mode=mode, block_words=64, **pkw), self.zmesh,
            checkpoint_dir=port_dir, device="cpu", **kw)
        self.ref.initialize()
        # the port starts from the reference's initial state
        self.port.initialize()
        self.port.pool.init(convert.train_state_to_port(
            np_tree(self.ref.prot.state), "cpu"))
        self.steps: list = []
        real = self.ref._train_step

        def record(state, batch):
            out = real(state, batch)
            self.steps.append((np_tree(state), np_tree(batch),
                               np_tree(out[0]), np_tree(out[1])))
            return out
        self.ref._train_step = record
        self.port._train_step = self.replay
        self.check()

    def replay(self, state, batch):
        st, b, new, metrics = self.steps.pop(0)
        got = utils.tree_leaves(state)
        for a, want in zip(got, jax.tree.leaves(st), strict=True):
            assert host_bytes(a) == want.tobytes(), "input state"
        assert batch.keys() == b.keys()
        for k in b:
            assert host_bytes(batch[k]) == b[k].tobytes(), f"batch {k}"
        return (convert.train_state_to_port(new, "cpu"),
                {k: torch.from_numpy(np.array(v)) for k, v in
                 metrics.items()})

    def check(self):
        if self.ref._engine is not None:
            want = tr.epoch_fields(self.ref._est, self.mesh)
            got = convert.from_port_epoch(self.port._est)
            tr.assert_same(want["prot"], got["prot"])
            for k in ("dirty", "pending", "acc"):
                tr._same(want[k], got[k], k)
        else:
            tr.assert_prot_same(self.ref.prot, self.mesh, self.port.prot)
        assert self.ref.cursor == self.port.cursor
        assert self.ref._host_step == self.port._host_step

    def step(self, **kw):
        r, p = self.ref.step(**kw), self.port.step(**kw)
        same_out(r, p)
        self.check()
        return p

    def run(self, n, **kw):
        r, p = self.ref.run(n, **kw), self.port.run(n, **kw)
        assert len(r) == len(p)
        for a, b in zip(r, p):
            same_out(a, b)
        self.check()
        return p

    def inject(self, ref_fn, port_fn):
        """The same fault into both pools (`Pool.inject`, which keeps an
        open window); returns (reference event, port event)."""
        return self.ref.pool.inject(ref_fn), self.port.pool.inject(port_fn)

    def recover(self, rev, pev):
        r, p = self.ref.on_failure(rev), self.port.on_failure(pev)
        for k in ("kind", "lost_rank", "pages", "verified", "reverified",
                  "synd_ok"):
            assert r.get(k) == p.get(k), k
        self.check()
        return p


def same_out(r, p):
    """A resolved step's summary, as the reference gives it."""
    assert r["step"] == p["step"] and r["committed"] == p["committed"]
    assert r["loss"] == p["loss"]
    assert r.get("dropped_replicas") == p.get("dropped_replicas")
    assert ("scrub" in r) == ("scrub" in p)
    if "scrub" in r:
        for k in ("checked", "bad_locations", "repaired"):
            assert r["scrub"][k] == p["scrub"][k], k


@pytest.mark.parametrize("mode", ["mlpc", "mlp", "ml", "replica", "none"])
def test_steps_keep_the_pool_byte_equal(mode):
    ls = Lockstep(mode)
    for _ in range(3):
        ls.step()
    if mode == "none":
        assert ls.port.prot.synd is None and ls.port.prot.cksums is None
    if mode == "replica":
        for a, b in zip(utils.tree_leaves(ls.port.prot.state),
                        utils.tree_leaves(ls.port.prot.replica)):
            assert torch.equal(a, b)


def test_microbatches_two_keep_the_pool_byte_equal():
    """At microbatches = 2, the split trainer's smallest: the port
    trainer's own accumulated step (two microbatches' gradients folded in
    f32) runs on the reference's input state and batch and agrees with the
    reference's step (the loss within 1e-6, each new state leaf within
    2e-5 of its largest magnitude: tests/test_torch_train_model.py's f32
    tolerances); the reference's step, replayed through the port's pool,
    keeps the pools byte-equal after every step."""
    ls = Lockstep(train=dict(TRAIN, microbatches=2))
    assert ls.port.train_cfg.microbatches == 2
    own = api.make_train_step(ls.port.model, ls.port.optimizer,
                              ls.port.train_cfg)

    def close(got, want, rtol):
        got, want = got.double(), want.double()
        err = float((got - want).abs().max())
        assert err <= rtol * max(float(want.abs().max()), 1e-30), err

    def both(state, batch):
        new, metrics = ls.replay(state, batch)
        got, got_metrics = own(state, batch)
        assert got_metrics.keys() == metrics.keys()
        close(got_metrics["loss"], metrics["loss"], 1e-6)
        for a, b in zip(utils.tree_leaves(got), utils.tree_leaves(new),
                        strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape
            close(a, b, 2e-5)
        return new, metrics
    ls.port._train_step = both
    for _ in range(3):
        ls.step()


def test_verify_old_and_the_scrub_cadence():
    ls = Lockstep(scrub_period=3)
    ls.port.verify_old = ls.ref.verify_old = True
    outs = [ls.step() for _ in range(3)]
    assert outs[-1]["scrub"]["checked"] and not outs[-1]["scrub"][
        "bad_locations"]


def test_rank_loss_scribble_and_canary_abort():
    ls = Lockstep()
    ls.run(2)
    rev, pev = ls.inject(
        lambda p, s: ref_failure.inject_rank_loss(p, s, rank=1),
        lambda p, s: failure.inject_rank_loss(p, s, rank=1))
    assert ls.recover(rev, pev)["verified"]
    ls.step()
    rev, pev = ls.inject(
        lambda p, s: ref_failure.inject_scribble(p, s, rank=0,
                                                 word_offsets=[3, 70]),
        lambda p, s: failure.inject_scribble(p, s, rank=0,
                                             word_offsets=[3, 70]))
    assert ls.recover(rev, pev)["verified"]
    before = ls.port.pool.step
    out = ls.step(canary_ok=False)
    assert not out["committed"] and ls.port.pool.step == before
    ls.step()


def test_r3_window4_depth4_through_a_three_rank_loss():
    ls = Lockstep(redundancy=3, window=4, pipeline_depth=4)
    assert ls.port.pool.engine is not None and ls.port.pipeline_depth == 4
    ls.run(6)
    rev, pev = ls.inject(
        lambda p, s: ref_failure.inject_multi_rank_loss(p, s, (0, 1, 3)),
        lambda p, s: failure.inject_multi_rank_loss(p, s, (0, 1, 3)))
    assert ls.recover(rev, pev)["verified"]
    ls.run(3)
    ls.port.flush()
    ls.ref.flush()
    ls.check()


def test_overlap_commit_folds_into_depth_two():
    ls = Lockstep(overlap_commit=True)
    assert ls.port.pipeline_depth == ls.ref.pipeline_depth == 2
    ls.run(3)


def test_checkpoint_restore_and_replay(tmp_path):
    """Both packages save at step 3 and go on to step 5 (steps 4-5 live
    only in the log); fresh trainers restore step 3 and step on in
    lockstep to the crashed pair's digest (the reference's crash test)."""
    ls = Lockstep(seed=3, ref_dir=str(tmp_path / "ref"),
                  port_dir=str(tmp_path / "port"))
    ls.run(3)
    ls.ref.save_checkpoint(wait=True)
    ls.port.save_checkpoint(wait=True)
    ls.run(2)
    fresh = Lockstep(seed=3, ref_dir=str(tmp_path / "ref"),
                     port_dir=str(tmp_path / "port"))
    r = fresh.ref.restore_from_checkpoint()
    p = fresh.port.restore_from_checkpoint()
    assert r == p == {"restored_step": 3, "replayed": []}
    fresh.check()
    fresh.run(2)
    for a, b in ((fresh.port.prot, ls.port.prot),):
        assert torch.equal(a.digest, b.digest) and torch.equal(a.row, b.row)


def test_port_replays_its_own_steps_to_the_logged_digests(tmp_path):
    """Crash recovery on the port's own train step: checkpoint at step 3,
    crash at step 6, a fresh trainer restores and replays 4-6 from the
    surviving log, each to its logged digest, ending byte-equal to the
    crashed trainer; a log whose digest was tampered with raises."""
    def trainer():
        t = Trainer(ModelConfig(**T_TRAIN), TrainConfig(**TRAIN),
                    ProtectConfig(block_words=64), tr.zone_mesh("mesh42"),
                    seq_len=SEQ, global_batch=BATCH, seed=5, device="cpu",
                    checkpoint_dir=str(tmp_path))
        return t
    t = trainer()
    t.initialize()
    t.run(3)
    t.save_checkpoint()                  # async; restore waits for it
    outs = t.run(3)
    t2 = trainer()
    info = t2.restore_from_checkpoint(log=t.prot.log)
    assert info == {"restored_step": 3, "replayed": [4, 5, 6]}
    assert [o["loss"] for o in t2.history] == [o["loss"] for o in outs]
    want, got = convert.from_port(t.prot), convert.from_port(t2.prot)
    # the restored pool's log starts empty: it holds the replayed records
    for k in ("step", "data_cursor", "rng", "digest", "mark"):
        assert (want["log"][k][4:7] == got["log"][k][4:7]).all(), k
    want["log"] = got["log"] = None
    tr.assert_same(want, got)
    bad = dataclasses.replace(t.prot.log, digest=t.prot.log.digest ^ 1)
    with pytest.raises(RuntimeError, match="replay digest mismatch at step 4"):
        trainer().restore_from_checkpoint(log=bad)
    # from the checkpoint's own log: nothing after step 3 to replay
    assert trainer().restore_from_checkpoint() == {"restored_step": 3,
                                                   "replayed": []}


def test_straggler_drops_masks_and_heals():
    """tests/test_chaos.py's trainer case: replica 1 at 10x is dropped, the
    loss-masked step (its mask handed to both train steps alike) commits,
    and the replica heals once its slowdown ends."""
    ls = Lockstep(straggler_threshold=2.0)
    ls.ref.pool.straggler = RefStraggler(4, threshold=2.0, window=2)
    ls.port.pool.straggler = StragglerPolicy(4, threshold=2.0, window=2)
    ls.ref.replica_slowdown[1] = ls.port.replica_slowdown[1] = 10.0
    outs = ls.run(4)
    assert all(o["committed"] for o in outs)
    assert ls.port.pool.dropped_replicas == [1]
    assert outs[-1].get("dropped_replicas") == [1]
    out = ls.step()
    assert out["committed"] and np.isfinite(out["loss"])
    ls.ref.replica_slowdown[1] = ls.port.replica_slowdown[1] = 1.0
    ls.run(2)
    assert ls.port.pool.dropped_replicas == []


def test_schedule_attachment_on_a_trainer():
    """tests/test_chaos.py's schedule case: a rank loss riding the step
    hook at step 1, its record the full recovery event."""
    ls = Lockstep()
    rlog = ref_attach(ls.ref, RefSchedule([RefE.make(1, "rank_loss", rank=2)],
                                          seed=0))
    plog = attach_schedule(ls.port, FaultSchedule(
        [ChaosEvent.make(1, "rank_loss", rank=2)], seed=0))
    outs = ls.run(3)
    assert all(o["committed"] for o in outs)
    assert len(plog) == len(rlog) == 1
    rec = plog[0]
    assert rec["step"] == 1 and rec["kind"] == "rank_loss"
    assert rec["verified"] is True and rec["reverified"] is True
    assert rec["lost_rank"] == 2
    assert rec["solve_ms"] >= 0 and rec["total_ms"] >= rec["solve_ms"]
    for k in ("step", "kind", "verified", "reverified", "lost_rank"):
        assert rec[k] == rlog[0][k], k


def test_metrics_and_trace_publication(tmp_path):
    from repro_torch import obs
    t = Trainer(ModelConfig(**T_TRAIN), TrainConfig(**TRAIN),
                ProtectConfig(block_words=64, scrub_period=2),
                tr.zone_mesh("mesh42"),
                seq_len=SEQ, global_batch=BATCH, device="cpu",
                metrics_dir=str(tmp_path / "m"), trace_dir=str(tmp_path / "t"),
                metrics_every=2)
    t.initialize()
    t.run(2)
    t.step(canary_ok=False)
    reg = t.pool.metrics
    assert reg.counter("trainer_steps_total").value == 3
    assert reg.counter("trainer_aborted_steps_total").value == 1
    assert (tmp_path / "m" / "trainer.prom").exists()
    events = obs.load_jsonl(str(tmp_path / "t" / "trainer.trace.jsonl"))
    assert any(e.get("kind") == "scrub" for e in events)
    assert obs.validate_events(events) == []


def test_launch_train_on_the_cpu(capsys):
    assert launch_train.main(["--arch", "qwen3-0.6b", "--steps", "3",
                              "--seq-len", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "final: step 3" in out and "tok/s" in out
    assert "health: green" in out
