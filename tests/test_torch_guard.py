"""Guards on the port's boundary: the package and chip_smoke.py import
neither JAX nor the reference; every configuration the reference accepts
opens a pool (none is refused or downgraded), and rescale runs; a
multi-rank loss beyond the redundancy is refused; and the pool's default
device is the card."""
import ast
import pathlib

import pytest
import torch

from repro_torch import P, Pool, ProtectConfig, ZoneMesh
from repro_torch.core.txn import Protector

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_warm_commits.py",
    ROOT / "scripts" / "torch_sass_counts.py",
    ROOT / "scripts" / "torch_dispatch_profile.py"]


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
