"""The moe family through the port's runtimes (Server, Trainer,
launch.serve, launch.train) against the reference's, on moonshot's
`reduced()` and the tests/test_models.py moe_top1 family over the (4, 2)
mesh (the reference's built with Auto axis types).  The model is in
tests/test_torch_moe_model.py.

moonshot's KV cache keeps its sequence a rank on (4, 2) (4 KV heads
split over `model`), so each decode step writes one time slot a leaf:
the patch path.  Protected bytes are compared where both packages see
the same values (tests/test_torch_ssm_runtime.py's `Served` and
`StateLockstep`): a port server fed the reference's decode outputs, a
port trainer replaying the reference's steps, end with the reference's
pool byte for byte.  The port's own decode gives the reference's greedy
tokens, and its own train step (routing in the mesh's four groups, the
aux weighed in) the reference trainer's losses within 1e-5.
"""
import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import MoESpec as RefMoESpec
from repro.configs.base import ProtectConfig as RefProtectConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.models import moe as ref_moe
from repro.runtime import failure as ref_failure
from repro.runtime.trainer import Trainer as RefTrainer
from repro_torch import convert
from repro_torch.configs.base import ModelConfig, ProtectConfig, TrainConfig
from repro_torch.runtime import failure
from repro_torch.runtime.trainer import Trainer
from tests import _torch_ref as tr
from tests.test_torch_moe import COMMON, FAMILIES
from tests.test_torch_ssm_runtime import Served, StateLockstep
from tests.test_torch_trainer import TRAIN
from tests._torch_ref import compile_cache, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("compile_cache", "one_thread")

ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b")


@pytest.fixture(autouse=True)
def _f32_dots(monkeypatch):
    tr.f32_dots(monkeypatch, ref_moe)


@pytest.fixture(scope="module")
def served():
    return Served("moonshot-v1-16b-a3b")


@pytest.mark.parametrize("r,window", [(1, 1), (3, 4)])
def test_server_matches_the_reference(served, r, window):
    """The moonshot server on (4, 2): a KV time slot a step (the patch
    path), the port's own tokens the reference's, a fed server's pool
    byte-equal to the reference server's."""
    served.check("mesh42", r, window)


def test_server_footprint_is_a_time_slot(served):
    srv = served.port("mesh42")
    lo = srv.protector.layout
    assert len(srv._dirty_pages(3)) < lo.n_blocks // 4
    words = srv._dirty_words(3)
    assert all(w is not None for w in words)


T_MOE = dict(COMMON, name="t_moe1", family="moe", n_layers=2, d_model=32,
             vocab=128, moe=RefMoESpec(**FAMILIES["moe_top1"]["moe"]))


def test_trainer_steps_keep_the_pool_byte_equal():
    """The port's Trainer in lockstep with the reference's (its step
    replaying the reference's): bulk steps, verify_old, a rank loss; the
    pools byte-equal after every step."""
    ls = StateLockstep(model=T_MOE)
    ls.run(2)
    ls.port.verify_old = ls.ref.verify_old = True
    ls.step()
    rev, pev = ls.inject(
        lambda p, s: ref_failure.inject_rank_loss(p, s, rank=1),
        lambda p, s: failure.inject_rank_loss(p, s, rank=1))
    assert ls.recover(rev, pev)["verified"]
    ls.step()


def test_trainers_own_steps_follow_the_references():
    """The port's Trainer with its own train step (routing in the mesh's
    four groups, the aux weighed in), from the reference's initial state:
    three steps' losses within 1e-5 of the reference trainer's."""
    mesh, zmesh = tr.jax_mesh("mesh42"), tr.zone_mesh("mesh42")
    kw = dict(seq_len=16, global_batch=8, seed=0)
    ref = RefTrainer(RefModelConfig(**T_MOE), RefTrainConfig(**TRAIN),
                     RefProtectConfig(mode="mlpc", block_words=64), mesh,
                     **kw)
    port = Trainer(ModelConfig(**T_MOE), TrainConfig(**TRAIN),
                   ProtectConfig(mode="mlpc", block_words=64), zmesh,
                   device="cpu", **kw)
    ref.initialize()
    port.initialize()
    port.pool.init(convert.train_state_to_port(
        jax.tree.map(np.asarray, ref.prot.state), "cpu"))
    want = [float(m["loss"]) for m in ref.run(3)]
    got = [float(m["loss"]) for m in port.run(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_launch_serve_moe(capsys):
    """`launch.serve` on moonshot's reduced config (max_len 7: off every
    cache axis)."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", "moonshot-v1-16b-a3b", "--device", "cpu",
                       "--batch", "4", "--prompt-len", "3",
                       "--new-tokens", "3", "--scrub-period", "2"]) == 0
    out = capsys.readouterr().out
    assert "arch=moonshot-v1-16b-a3b generated (4, 3)" in out
    assert "health: green" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_moe(arch, capsys):
    from repro_torch.launch import train
    assert train.main(["--arch", arch, "--reduced", "--steps", "2",
                       "--seq-len", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "final: step 2" in out and "health: green" in out
