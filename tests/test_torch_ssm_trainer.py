"""The ssm family through the port's training runtime (Trainer,
launch.train) against the reference's, on a 2-layer xLSTM (an mLSTM and
an sLSTM block at d_model 32) over the (4, 2) mesh:
the port's trainer replays the reference's train step (`StateLockstep`,
tests/test_torch_ssm_runtime.py) and the two pools are byte-equal after
every step.
"""
import pytest

from repro.runtime import failure as ref_failure
from repro_torch.runtime import failure
from tests.test_torch_ssm_runtime import ARCH, T_XL, StateLockstep
from tests._torch_ref import compile_cache, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("compile_cache", "one_thread")


def test_trainer_steps_keep_the_pool_byte_equal():
    """The port's Trainer in lockstep with the reference's (its train step
    replaying the reference's outputs): bulk steps, verify_old, a rank
    loss and recovery; the pools byte-equal after every step."""
    ls = StateLockstep(model=T_XL)
    ls.run(2)
    ls.port.verify_old = ls.ref.verify_old = True
    ls.step()
    rev, pev = ls.inject(
        lambda p, s: ref_failure.inject_rank_loss(p, s, rank=1),
        lambda p, s: failure.inject_rank_loss(p, s, rank=1))
    assert ls.recover(rev, pev)["verified"]
    ls.step()


def test_launch_train_ssm(capsys):
    from repro_torch.launch import train
    assert train.main(["--arch", ARCH, "--reduced", "--steps", "2",
                       "--seq-len", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "final: step 2" in out and "health: green" in out
