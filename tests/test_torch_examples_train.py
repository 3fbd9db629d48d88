"""The port's training example (examples/torch_train_fault_tolerant.py)
on the CPU, against the reference's Trainer, as test_torch_trainer.py
holds the port's Trainer to it.

The example's --smoke pass (30 steps of an 8-layer d_model-64
qwen2-family model, f32, through a scribble + scrub, a rank loss, a
canary abort and a crash with checkpoint restore + replay) runs with its
own asserts, from the reference Trainer's initial state, its train step
replaying the reference's: the outputs the reference's train step gave
for the same step of a clean run, after checking that the port's handed
it the reference's input state and batch byte for byte.  So every fault
of the timeline leaves the state the step reads as the reference's, and
the 30 losses are the reference's exactly (test_torch_trainer.py's
tolerance).  The two packages' own train steps are not compared over 30
steps: at this width and depth the gradients at init reach ~50 and the
runs part by rounding within three steps (~4e-3 of the loss).
"""
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import ProtectConfig as RefProtectConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.runtime.trainer import Trainer as RefTrainer
from repro_torch import convert, utils
from repro_torch.runtime import trainer as trainer_mod
from repro_torch.runtime.trainer import Trainer
from tests import _torch_ref as tr
from tests._torch_ref import compile_cache, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("compile_cache", "one_thread")

EXAMPLE = (pathlib.Path(__file__).resolve().parents[1] / "examples"
           / "torch_train_fault_tolerant.py")


def test_train_example_gives_the_references_losses(monkeypatch, tmp_path):
    spec = importlib.util.spec_from_file_location("torch_train", EXAMPLE)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    args = ex.parse(["--smoke", "--device", "cpu"])
    cfg = ex.build_cfg(args.d_model)
    fields = {f: getattr(cfg, f) for f in (
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv", "d_ff",
        "vocab", "qkv_bias", "param_dtype", "compute_dtype")}
    ref = RefTrainer(
        RefModelConfig(**fields),
        RefTrainConfig(learning_rate=1e-3, warmup_steps=20,
                       total_steps=args.steps),
        RefProtectConfig(mode=args.mode, scrub_period=50),
        tr.jax_mesh("mesh42"), seq_len=args.seq_len,
        global_batch=args.batch, seed=0)
    ref.initialize()
    start = convert.train_state_to_port(
        jax.tree.map(np.asarray, ref.prot.state), "cpu")
    steps = {}
    real = ref._train_step

    def record(state, batch):
        out = real(state, batch)
        steps[int(np.asarray(state["step"]))] = tuple(
            jax.tree.map(np.asarray, x) for x in (state, batch) + out)
        return out
    ref._train_step = record
    want = [ref.step()["loss"] for _ in range(args.steps)]

    def replay(state, batch):
        st, b, new, metrics = steps[int(state["step"])]
        for a, w in zip(utils.tree_leaves(state), jax.tree.leaves(st),
                        strict=True):
            assert convert._np_leaf(a).tobytes() == w.tobytes(), \
                "input state"
        assert batch.keys() == b.keys()
        for k in b:
            assert convert._np_leaf(batch[k]).tobytes() == b[k].tobytes()
        return (convert.train_state_to_port(new, "cpu"),
                {k: torch.from_numpy(np.array(v)) for k, v in
                 metrics.items()})
    monkeypatch.setattr(trainer_mod.api, "make_train_step",
                        lambda *a: replay)
    init = Trainer.initialize

    def from_the_reference(self, gen=None, params=None):
        init(self, params=start["params"])
    monkeypatch.setattr(Trainer, "initialize", from_the_reference)
    losses = ex.main(["--smoke", "--device", "cpu", "--ckpt-dir",
                      str(tmp_path)])
    assert len(losses) == len(want) == 30
    assert losses == want
