"""Shared fixtures.

The protection core runs inside shard_map over a ("data", "model") mesh, so
the test process forces EIGHT host devices (not 512 — the production-mesh
dry-run owns that flag and runs as its own process; keeping the test count
small keeps CPU smoke tests fast).  This must happen before jax's first
import anywhere in the pytest process, which conftest guarantees.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import sys

try:                             # the container image may not ship hypothesis
    import hypothesis            # noqa: F401
except ImportError:
    from tests import _hypothesis_stub
    sys.modules["hypothesis"] = _hypothesis_stub
    sys.modules["hypothesis.strategies"] = _hypothesis_stub
    _hypothesis_stub.strategies = _hypothesis_stub

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


@pytest.fixture(scope="session")
def mesh42() -> Mesh:
    """4-way data (zone) axis x 2-way model axis."""
    return jax.make_mesh((4, 2), ("data", "model"))


@pytest.fixture(scope="session")
def mesh81() -> Mesh:
    """8-way data axis (pure zone; power of two for tree reduce)."""
    return jax.make_mesh((8, 1), ("data", "model"))


@pytest.fixture(scope="session")
def mesh_pod() -> Mesh:
    """Tiny multi-pod mesh (2 pods x 2 data x 2 model)."""
    return jax.make_mesh((2, 2, 2), ("pod", "data", "model"))


def small_state(mesh):
    """Heterogeneous protected state: f32 FSDP+TP, bf16 TP, replicated scalar."""
    specs = {
        "w1": P("data", "model"),
        "w2": P(None, "model"),
        "scale": P(),
    }
    state = {
        "w1": jnp.arange(8 * 64, dtype=jnp.float32).reshape(8, 64) * 0.1,
        "w2": (jnp.arange(16 * 32, dtype=jnp.float32) * 0.01
               ).astype(jnp.bfloat16).reshape(16, 32),
        "scale": jnp.float32(3.25),
    }
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                             is_leaf=lambda x: isinstance(x, P))
    state = jax.tree.map(jax.device_put, state, shardings)
    return state, specs, shardings


@pytest.fixture()
def tiny_dense_cfg():
    from repro.configs.base import ModelConfig
    return ModelConfig(
        name="t_dense", family="dense", n_layers=2, d_model=32, n_heads=4,
        n_kv=2, d_ff=64, vocab=128, param_dtype="float32",
        compute_dtype="float32")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where CUDA is absent)")
