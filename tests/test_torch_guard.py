"""Guards on the port's boundary: the package, chip_smoke.py, the port's
scripts (scripts/torch_*.py) and examples (examples/torch_*.py), and the
split-zone tests' worker code (tests/_torch_procs_worker.py,
tests/_torch_procs_window_worker.py, tests/_torch_procs_hosts_worker.py,
tests/_torch_procs_chaos_worker.py, tests/_torch_procs_regroup_worker.py)
import neither JAX nor the reference; every configuration the reference accepts
opens a pool (none is refused or downgraded), and rescale runs; a
multi-rank loss beyond the redundancy is refused; and the pool's default
device is the card."""
import ast
import pathlib

import pytest
import torch

from repro_torch import P, Pool, ProtectConfig, ZoneMesh
from repro_torch.core.txn import Protector
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + [ROOT / "chip_smoke.py",
                 ROOT / "tests" / "_torch_procs_worker.py",
                 ROOT / "tests" / "_torch_procs_window_worker.py",
                 ROOT / "tests" / "_torch_procs_hosts_worker.py",
                 ROOT / "tests" / "_torch_procs_chaos_worker.py",
                 ROOT / "tests" / "_torch_procs_regroup_worker.py"]
              + sorted((ROOT / "scripts").glob("torch_*.py"))
              + sorted((ROOT / "examples").glob("torch_*.py")))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def _tiny():
    mesh = ZoneMesh((4, 1), ("data", "model"))
    state = {"w": torch.zeros(8, 16)}
    return mesh, state, {"w": P("data")}


@pytest.mark.parametrize("cfg", [
    dict(redundancy=2), dict(mode="mlpc2"), dict(window=4),
    dict(pipeline_depth=2), dict(overlap_commit=True),
    dict(straggler_threshold=1.5)])
def test_unported_configurations_raise(cfg):
    """Each configuration that once raised (naming the slice that ports
    it) now opens a pool: redundancy 2 (directly or as the mlpc2 alias)
    with a two-plane stack, window 4 on the deferred engine,
    pipeline_depth 2 / overlap_commit with the async commit ring, and
    straggler_threshold 1.5 with a straggler policy over the zone's
    ranks."""
    mesh, state, specs = _tiny()
    config = ProtectConfig(**cfg)
    if config.pipeline_depth > 1 or config.overlap_commit:
        pool = Pool.open(state, specs, mesh=mesh, config=config,
                         device="cpu")
        assert pool.stats()["pipeline_depth"] == config.pipeline_depth
        assert pool.commit_async(state).result() is True
        return
    if config.window > 1:
        pool = Pool.open(state, specs, mesh=mesh, config=config,
                         device="cpu")
        assert pool.engine.window == 4 and pool.stats()["engine"] == \
            "deferred"
        return
    if config.resolved_redundancy > 1:
        pool = Pool.open(state, specs, mesh=mesh, config=config,
                         device="cpu")
        assert pool.redundancy == 2 and pool.prot.synd.shape[-2] == 2
        return
    pool = Pool.open(state, specs, mesh=mesh, config=config, device="cpu")
    assert pool.straggler.threshold == 1.5
    assert pool.straggler.n_replicas == 4
    assert pool.observe_commit_times([0.01] * 4).all()


def test_unported_entry_points_raise():
    """Pool.rescale and PoolGroup.rescale, which raised until their slice
    (S6) was ported, return rescaled pools; commit_async runs; a Protector
    at r = 2 builds; two losses on an r = 1 pool are the budget refusal,
    latched in the health surface and the metrics until `init` re-arms
    the pool."""
    from repro_torch import Fault
    from repro_torch.tenancy import PoolGroup
    mesh, state, specs = _tiny()
    pool = Pool.open(state, specs, mesh=mesh, device="cpu")
    assert pool.commit_async(state).result() is True
    wide = ZoneMesh((8, 1), ("data", "model"))
    rescaled = pool.rescale(wide)
    assert rescaled.protector.group_size == 8 and rescaled.step == 1
    assert torch.equal(rescaled.state["w"], state["w"])
    group = PoolGroup(mesh, device="cpu")
    group.admit("t0", state, specs)
    moved = group.rescale(wide)
    assert moved["t0"].pool.protector.group_size == 8
    assert torch.equal(moved["t0"].pool.state["w"], state["w"])
    assert Protector(mesh, state, specs, mode="mlp",
                     redundancy=2).redundancy == 2
    with pytest.raises(RuntimeError, match="syndrome budget exhausted"):
        pool.recover(Fault.multi_loss(0, 1))
    assert pool.stats()["budget_exhausted"]
    assert pool.metrics.counter("pool_budget_exhausted_total").value == 1
    assert pool.metrics.gauge("pool_budget_remaining").value == 0
    assert pool.health().status == "critical"
    pool.init(state)
    assert not pool.stats()["budget_exhausted"]
    assert pool.metrics.gauge("pool_budget_remaining").value == 1


def test_default_device_is_the_card(monkeypatch):
    from repro_torch import convert
    from repro_torch.runtime import failure
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh, state, specs = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pool.open(state, specs, mesh=mesh)
    from repro_torch.tenancy import PoolGroup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PoolGroup(mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        failure.smashed_canary_buffer(64)
    fields = {"state": {"w": state["w"].numpy()}, "step": 0}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.to_port(fields)
    assert convert.to_port(fields, device="cpu").step.device.type == "cpu"


@pytest.mark.parametrize("arch", [
    "llama4-maverick-400b-a17b", "moonshot-v1-16b-a3b",
    "seamless-m4t-large-v2", "chameleon-34b", "recurrentgemma-2b",
    "xlstm-1.3b", "minitron-8b", "qwen2-0.5b", "glm4-9b", "qwen3-0.6b"])
def test_build_model_holds_to_its_families(arch):
    """Every family builds, each its own pattern (the hybrid with its
    unstacked tail; xlstm 7 x mlstm + slstm; moonshot ("moe",), maverick
    ("dense", "moe")); the audio family an `EncDecModel` of ("dec_x",)
    behind its ("enc",) stack, 24 + 24 groups published; for the
    published and the reduced config alike, and no other family stands
    in.  No block type is held back for a later slice."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import blocks
    from repro_torch.models.transformer import (EncDecModel, Model,
                                                build_model)
    want = {"xlstm-1.3b": ("mlstm",) * 7 + ("slstm",),
            "moonshot-v1-16b-a3b": ("moe",),
            "llama4-maverick-400b-a17b": ("dense", "moe")}
    for reduced in (False, True):
        cfg = get_config(arch, reduced=reduced)
        model = build_model(cfg)
        if cfg.family == "audio":
            assert type(model) is EncDecModel and cfg.enc_layers > 0
            assert model.pattern == ("dec_x",) and model.tail == ()
            assert model.enc_pattern == ("enc",)
            assert (model.n_enc_groups, model.n_groups) == (
                (2, 2) if reduced else (24, 24))
            continue
        assert type(model) is Model and model.pattern == cfg.pattern
        assert model.tail == cfg.tail_pattern
        if cfg.family in ("ssm", "moe") and not reduced:
            assert model.pattern == want[arch] and model.tail == ()
        assert cfg.family in ("hybrid", "ssm", "moe") or \
            model.pattern == ("dense",)
    for btype in ("enc", "dec_x"):
        assert blocks.block_defs(cfg, btype)["attn"]
    assert not hasattr(blocks, "LATER")


def test_model_plane_defaults_to_the_card(monkeypatch):
    """Model.init / init_cache, the Server, params_to_port and the serve
    launcher run on the card unless asked for the CPU; without one they
    raise."""
    from repro_torch import convert
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime.server import Server
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(cfg, ProtectConfig(), ZoneMesh((4, 2), ("data", "model")),
               batch=4, max_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_to_port({"w": torch.zeros(2).numpy()})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-0.6b"])
    assert model.init_cache(2, 8, device="cpu")["groups"]["b0_dense"][
        "k"].device.type == "cpu"


def test_training_plane_defaults_to_the_card(monkeypatch, tmp_path):
    """The Trainer, its train state, data, checkpoints, the converter and
    the train launcher run on the card unless asked for the CPU; without
    one they raise."""
    from repro_torch import convert
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.models.transformer import build_model
    from repro_torch.optim import build_optimizer
    from repro_torch.runtime.trainer import Trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-0.6b", reduced=True)
    mesh = ZoneMesh((4, 2), ("data", "model"))
    model, opt = build_model(cfg), build_optimizer(TrainConfig(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainConfig(), ProtectConfig(), mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_train_state(model, opt, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_for(cfg, 8, 2).device_batch(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CheckpointManager(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.train_state_to_port({"params": {}, "opt": {}, "step": 0})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen3-0.6b"])
    state = api.init_train_state(model, opt, torch.Generator().manual_seed(0),
                                 "cpu")
    assert state["step"].device.type == "cpu"
