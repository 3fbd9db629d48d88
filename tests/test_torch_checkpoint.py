"""The port's disk checkpoints (repro_torch.checkpoint.manager) against
the reference's: the same on-disk format, so that a checkpoint written by
one package restores in the other to equal arrays (and redo log), the
same per-leaf digests (summed in chunks in the port), async saves, GC and
corruption detection.  Everything here is exact.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.checkpoint import manager as ref_manager
from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core import redolog as ref_redolog
from repro.models import api as ref_api
from repro.models.transformer import build_model as ref_build
from repro.optim import build_optimizer as ref_build_optimizer
from repro_torch import convert, utils
from repro_torch.checkpoint import manager
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import redolog
from repro_torch.models import api
from repro_torch.models.transformer import build_model
from repro_torch.optim import build_optimizer
from tests import _torch_ref as tr
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CFG = dict(name="t_ckpt", family="dense", n_layers=2, d_model=32, n_heads=4,
           n_kv=2, d_ff=64, vocab=128, qk_norm=True)


def ref_state(seed=0, optimizer="adamw"):
    cfg = RefModelConfig(**CFG)
    opt = ref_build_optimizer(RefTrainConfig(optimizer=optimizer), cfg)
    model = ref_build(cfg)
    st = ref_api.init_train_state(model, opt, jax.random.PRNGKey(seed))
    return st, model, opt


def port_side(optimizer="adamw"):
    cfg = ModelConfig(**CFG)
    model = build_model(cfg)
    opt = build_optimizer(TrainConfig(optimizer=optimizer), cfg)
    return (api.train_state_specs(model, opt, tr.zone_mesh("mesh42")),
            api.abstract_train_state(model, opt))


def ref_log(n=5):
    log = ref_redolog.make(8)
    for s in range(1, n + 1):
        log = ref_redolog.append(
            log, s, s * 3, jax.random.fold_in(jax.random.PRNGKey(7), s),
            jnp.asarray([s, 2 ** 32 - s], jnp.uint32))
        log = ref_redolog.commit_mark(log, s)
    return log


@pytest.mark.parametrize("dtype,n", [(np.float32, 1000), (np.int32, 1),
                                     (np.uint8, 7), (np.int16, 5),
                                     (np.float32, 0)])
@pytest.mark.parametrize("chunk", [3, 1 << 22])
def test_digest_is_the_references(monkeypatch, dtype, n, chunk):
    monkeypatch.setattr(manager, "_DIGEST_CHUNK", chunk)
    rng = np.random.default_rng(n)
    a = (rng.standard_normal(n) * 1000).astype(dtype)
    assert manager._digest(a) == ref_manager._digest(a)
    z = np.asarray(np.float32(3.5))                     # a 0-d leaf
    assert manager._digest(z) == ref_manager._digest(z)


def test_keys_are_jax_keystrs():
    st, _, _ = ref_state()
    want = list(ref_manager._flatten_with_paths(st))
    got = list(manager._flatten_with_paths(
        convert.train_state_to_port(jax.tree.map(np.asarray, st), "cpu")))
    assert sorted(got) == sorted(want)
    assert "['params']['embed']['tok']" in got
    assert "['opt']['m']['groups']['b0_dense']['attn']['wq']" in got


def same_state(got, want_np):
    got_leaves = utils.tree_leaves(got)
    want = jax.tree.leaves(want_np)
    assert len(got_leaves) == len(want)
    for a, b in zip(got_leaves, want):
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 \
            else a.numpy()
        assert a.shape == np.asarray(b).shape
        assert a.tobytes() == np.asarray(b).tobytes()


def port_log(ref):
    return redolog.RedoLog(**{
        k: torch.from_numpy(np.asarray(getattr(ref, k)).view(np.int32).copy())
        for k in ("step", "data_cursor", "rng", "digest", "mark")})


def same_log(got, ref):
    for k in ("step", "data_cursor", "rng", "digest", "mark"):
        assert got_words(getattr(got, k)) == np.asarray(
            getattr(ref, k)).tobytes(), k


def got_words(t):
    return t.cpu().numpy().view(np.uint32).tobytes()


@pytest.mark.parametrize("blocking", [True, False])
def test_round_trip(tmp_path, blocking):
    st, _, _ = ref_state(1)
    st_np = jax.tree.map(np.asarray, st)
    specs, _ = port_side()
    mgr = manager.CheckpointManager(str(tmp_path), state_specs=specs,
                                    device="cpu")
    log = port_log(ref_log())
    mgr.save(3, convert.train_state_to_port(st_np, "cpu"),
             extra={"cursor": 11, "log": log}, blocking=blocking)
    mgr.wait()
    step, state, extra = mgr.restore_latest()
    assert step == 3 and extra["cursor"] == 11
    same_state(state, st_np)
    same_log(manager.log_from_extra(extra["log"], "cpu"), ref_log())
    # without a spec tree the state comes back flat, by key
    flat, _ = manager.CheckpointManager(str(tmp_path),
                                        device="cpu").restore(3)
    assert "['step']" in flat and flat["['step']"].dim() == 0


def test_async_saves_and_gc_keep_the_newest(tmp_path):
    specs, _ = port_side()
    st = convert.train_state_to_port(
        jax.tree.map(np.asarray, ref_state()[0]), "cpu")
    mgr = manager.CheckpointManager(str(tmp_path), state_specs=specs,
                                    keep=2, device="cpu")
    for s in (1, 2, 3, 4):
        mgr.save(s, st, extra={"cursor": s})      # each waits for the last
    mgr.wait()
    assert mgr.list_steps() == [3, 4]
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
    assert mgr.restore_latest()[0] == 4


def test_digest_corruption_and_shape_checks(tmp_path):
    specs, abstract = port_side()
    st_np = jax.tree.map(np.asarray, ref_state()[0])
    mgr = manager.CheckpointManager(str(tmp_path), state_specs=specs,
                                    device="cpu")
    mgr.save(5, convert.train_state_to_port(st_np, "cpu"), blocking=True)
    with pytest.raises(ValueError, match="different model configuration"):
        bad = utils.tree_map(lambda x: x, abstract)
        bad["params"]["final_norm"]["scale"] = torch.empty(7, device="meta")
        mgr.restore(5, template=bad)
    mgr.restore(5, template=abstract)
    path = os.path.join(tmp_path, "step_5", "arrays.npz")
    arrays = dict(np.load(path))
    key = "['params']['final_norm']['scale']"
    arrays[key] = arrays[key] + 1
    np.savez(path, **arrays)
    with pytest.raises(RuntimeError, match="digest mismatch"):
        mgr.restore(5)
    with pytest.raises(FileNotFoundError):
        manager.CheckpointManager(str(tmp_path / "empty"),
                                  device="cpu").restore_latest()


def test_bf16_leaves_round_trip(tmp_path):
    mgr = manager.CheckpointManager(str(tmp_path), device="cpu")
    x = torch.randn(5, 3).to(torch.bfloat16)
    mgr.save(1, {"m": x, "n": torch.arange(4)}, blocking=True)
    state, _ = mgr.restore(1)
    assert state["['m']"].dtype == torch.bfloat16
    assert torch.equal(state["['m']"], x)
    with open(os.path.join(tmp_path, "step_1", "manifest.json")) as f:
        assert json.load(f)["bf16"] == ["['m']"]


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """A checkpoint the port writes (train state + cursor + redo log)
    restores through the reference's CheckpointManager to equal arrays,
    and its redo log decodes, as the reference's trainer decodes it, to
    the same words."""
    st_np = jax.tree.map(np.asarray, ref_state(2)[0])
    specs, _ = port_side()
    mgr = manager.CheckpointManager(str(tmp_path), state_specs=specs,
                                    device="cpu")
    mgr.save(7, convert.train_state_to_port(st_np, "cpu"),
             extra={"cursor": 9, "log": port_log(ref_log())}, blocking=True)
    _, model, opt = ref_state()
    mesh = tr.jax_mesh("mesh42")
    ref_mgr = ref_manager.CheckpointManager(
        str(tmp_path), mesh, ref_api.train_state_specs(model, opt, mesh))
    step, state, extra = ref_mgr.restore_latest()
    assert step == 7 and extra["cursor"] == 9
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(st_np),
                    strict=True):
        assert np.asarray(a).tobytes() == b.tobytes()
    log = extra["log"]
    assert log["__pytree__"] == "RedoLog"
    children = [np.asarray(c["__ndarray__"], dtype=c["dtype"]).reshape(
        c["shape"]) for c in log["children"]]
    want = ref_log()
    for c, k in zip(children, ("step", "data_cursor", "rng", "digest",
                               "mark")):
        assert c.dtype == np.uint32
        assert c.tobytes() == np.asarray(getattr(want, k)).tobytes()


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A checkpoint the reference writes (its train state, cursor and a
    serialized RedoLog) restores through the port's manager to equal
    tensors and redo-log words."""
    st, model, opt = ref_state(3)
    mesh = tr.jax_mesh("mesh42")
    ref_mgr = ref_manager.CheckpointManager(
        str(tmp_path), mesh, ref_api.train_state_specs(model, opt, mesh))
    ref_mgr.save(4, st, extra={"cursor": 5,
                               "log": jax.device_get(ref_log())},
                 blocking=True)
    specs, _ = port_side()
    mgr = manager.CheckpointManager(str(tmp_path), state_specs=specs,
                                    device="cpu")
    step, state, extra = mgr.restore_latest()
    assert step == 4 and extra["cursor"] == 5
    same_state(state, jax.tree.map(np.asarray, st))
    same_log(manager.log_from_extra(extra["log"], "cpu"), ref_log())


def test_adafactor_state_round_trips_between_packages(tmp_path):
    """Adafactor's factored state written by the reference restores in the
    port, by key.  (Restored flat: the reference's Adafactor `state_specs`
    gives a stacked 1-D leaf, a norm scale of shape (layers, hd) with the
    spec P(), one {"v"} spec for its {"vr", "vc"} state, so neither
    package can build the state's tree from its specs; ROADMAP queue C.)"""
    st, model, opt = ref_state(4, "adafactor")
    mesh = tr.jax_mesh("mesh42")
    specs = ref_api.train_state_specs(model, opt, mesh)
    assert specs["opt"]["groups"]["b0_dense"]["attn"]["knorm"].keys() == {
        "v"}
    assert st["opt"]["groups"]["b0_dense"]["attn"]["knorm"].keys() == {
        "vr", "vc"}
    ref_manager.CheckpointManager(str(tmp_path)).save(1, st, blocking=True)
    flat, _ = manager.CheckpointManager(str(tmp_path), device="cpu").restore(
        1)
    want = ref_manager._flatten_with_paths(jax.tree.map(np.asarray, st))
    assert flat.keys() == want.keys()
    for k in want:
        assert flat[k].numpy().tobytes() == want[k].tobytes(), k
