"""The hybrid and vlm families through the port's training runtime
(Trainer, launch.train) against the reference's, on reduced models over
the (4, 2) mesh (the reference's built with Auto axis types).

As in tests/test_torch_trainer.py (whose `Lockstep` this file drives with
other model configs), float math differs in the last bits between the
packages, so the port's train step replays the reference's outputs,
after checking that it was handed the reference's input state and batch
(the vlm's stub embeddings included) byte for byte, and the two pools
are byte-equal after every step.
"""
import pytest

from repro.runtime import failure as ref_failure
from repro_torch.runtime import failure
from tests.test_torch_trainer import Lockstep
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


T_HYB = dict(name="t_hyb", family="hybrid",
             block_pattern=("rglru", "rglru", "attn"), window=8,
             n_layers=5, d_model=32, n_heads=4, n_kv=1, d_ff=64, vocab=128,
             param_dtype="float32", compute_dtype="float32")
T_VLM = dict(name="t_vlm", family="vlm", mm_positions=4, n_layers=2,
             d_model=32, n_heads=4, n_kv=2, d_ff=64, vocab=128,
             qk_norm=True, param_dtype="float32", compute_dtype="float32")


@pytest.mark.parametrize("model", [T_HYB, T_VLM], ids=["hybrid", "vlm"])
def test_trainer_steps_keep_the_pool_byte_equal(model):
    """The port's Trainer in lockstep with the reference's (its train step
    replaying the reference's outputs; the vlm batch carries the stub
    embeddings): bulk steps, verify_old, a rank loss; the pools byte-equal
    after every step."""
    ls = Lockstep(model=model)
    ls.run(2)
    ls.port.verify_old = ls.ref.verify_old = True
    ls.step()
    rev, pev = ls.inject(
        lambda p, s: ref_failure.inject_rank_loss(p, s, rank=1),
        lambda p, s: failure.inject_rank_loss(p, s, rank=1))
    assert ls.recover(rev, pev)["verified"]
    ls.step()
    if model is T_VLM:
        assert "mm_embeds" in ls.port.stream.batch_at(0)


def test_trainer_r3_window4_on_the_hybrid():
    ls = Lockstep(model=T_HYB, redundancy=3, window=4, pipeline_depth=2)
    ls.run(5)
    ls.port.flush()
    ls.ref.flush()
    ls.check()


def test_initialize_takes_given_parameters():
    """`Trainer.initialize(params=...)` opens the pool over those
    parameters (as chip_smoke's rt does with its soft attention), zero
    moments and step 0; a step then trains them."""
    import torch
    from repro_torch import ZoneMesh, utils
    from repro_torch.configs.base import (ModelConfig, ProtectConfig,
                                          TrainConfig)
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime.trainer import Trainer
    cfg = ModelConfig(**T_HYB)
    params = build_model(cfg).init(torch.Generator().manual_seed(3), "cpu")
    want = utils.tree_map(torch.clone, params)
    t = Trainer(cfg, TrainConfig(), ProtectConfig(mode="mlpc"),
                ZoneMesh((4, 2), ("data", "model")), seq_len=16,
                global_batch=8, device="cpu")
    t.initialize(params=params)
    state = t.pool.state
    for a, b in zip(utils.tree_leaves(state["params"]),
                    utils.tree_leaves(want), strict=True):
        assert torch.equal(a, b)
    assert all(not x.any() for x in utils.tree_leaves(state["opt"]))
    assert int(state["step"]) == 0
    t.step()
    assert int(t.pool.state["step"]) == 1
    assert not all(torch.equal(a, b) for a, b in zip(
        utils.tree_leaves(t.pool.state["params"]), utils.tree_leaves(want)))


def test_launch_train_hybrid(capsys):
    from repro_torch.launch import train
    assert train.main(["--arch", "recurrentgemma-2b", "--reduced",
                       "--steps", "2", "--seq-len", "16",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "final: step 2" in out and "health: green" in out
