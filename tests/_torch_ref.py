"""Shared helpers for the port's tests: the reference (JAX) and the port
(PyTorch) fed the same numpy inputs, and their protected states compared
byte for byte.

The reference's meshes are built with Auto axis types: under jax 0.9
`jax.make_mesh` defaults to Explicit axes, on which the reference's
`Protector.commit` raises a ShardingTypeError at core/txn.py:514.  The
shapes and axis names are those of the conftest fixtures.
"""
import jax
import numpy as np
import torch
from jax.sharding import AxisType, NamedSharding, PartitionSpec

from repro_torch import convert, utils
from repro_torch.dist.sharding import P, ZoneMesh

MESHES = {
    "mesh42": ((4, 2), ("data", "model")),
    "mesh81": ((8, 1), ("data", "model")),
    "mesh_pod": ((2, 2, 2), ("pod", "data", "model")),
}


def jax_mesh(name):
    shape, axes = MESHES[name]
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def zone_mesh(name):
    shape, axes = MESHES[name]
    return ZoneMesh(shape, axes)


def small_state_np():
    """conftest.small_state's values as numpy (bf16 via ml_dtypes) + specs."""
    import jax.numpy as jnp
    state = {
        "w1": np.asarray(jnp.arange(8 * 64, dtype=jnp.float32)
                         .reshape(8, 64) * 0.1),
        "w2": np.asarray((jnp.arange(16 * 32, dtype=jnp.float32) * 0.01)
                         .astype(jnp.bfloat16).reshape(16, 32)),
        "scale": np.asarray(jnp.float32(3.25)),
    }
    specs = {"w1": ("data", "model"), "w2": (None, "model"), "scale": ()}
    return state, specs


def jax_specs(specs):
    return {k: PartitionSpec(*v) for k, v in specs.items()}


def port_specs(specs):
    return {k: P(*v) for k, v in specs.items()}


def to_jax(state_np, specs, mesh):
    js = jax_specs(specs)
    return {k: jax.device_put(v, NamedSharding(mesh, js[k]))
            for k, v in state_np.items()}


def to_torch(state_np):
    """Global numpy leaves -> CPU tensors (bf16 bit-exact)."""
    return utils.tree_map(lambda a: convert._leaf(a, "cpu"), state_np)


def stacked(arr, mesh) -> np.ndarray:
    """A jax.Array's per-device shards, zone-stacked in mesh order."""
    by_dev = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
    shards = [by_dev[d.id] for d in mesh.devices.flat]
    return np.stack(shards).reshape(mesh.devices.shape + shards[0].shape)


def ref_fields(prot, mesh) -> dict:
    """The reference's ProtectedState as convert's field dict (numpy)."""
    def arr(x):
        return None if x is None else np.asarray(x)
    log = None
    if prot.log is not None:
        log = {k: np.asarray(getattr(prot.log, k))
               for k in ("step", "data_cursor", "rng", "digest", "mark")}
    return {
        "state": {k: stacked(v, mesh) for k, v in prot.state.items()},
        "replica": (None if prot.replica is None else
                    {k: stacked(v, mesh) for k, v in prot.replica.items()}),
        "synd": arr(prot.synd), "cksums": arr(prot.cksums),
        "digest": arr(prot.digest), "row": arr(prot.row),
        "log": log, "step": np.asarray(prot.step),
    }


def _same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, f"{what}: {a is None} vs {b is None}"
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    assert a.tobytes() == b.tobytes(), f"{what}: bytes differ"


def assert_same(ref: dict, port: dict) -> None:
    """Every field of two field dicts byte-equal."""
    for k in ("synd", "cksums", "digest", "row", "step"):
        _same(ref[k], port[k], k)
    for tree in ("state", "replica"):
        if ref[tree] is None or port[tree] is None:
            assert ref[tree] is None and port[tree] is None, tree
            continue
        assert ref[tree].keys() == port[tree].keys(), tree
        for k in ref[tree]:
            _same(ref[tree][k], port[tree][k], f"{tree}.{k}")
    if ref["log"] is None or port["log"] is None:
        assert ref["log"] is None and port["log"] is None, "log"
    else:
        for k in ref["log"]:
            _same(ref["log"][k], port["log"][k], f"log.{k}")


def assert_prot_same(ref_prot, mesh, port_prot) -> None:
    assert_same(ref_fields(ref_prot, mesh), convert.from_port(port_prot))


def words(t: torch.Tensor) -> np.ndarray:
    """Port int32 words -> the reference's uint32 view."""
    return t.cpu().numpy().view(np.uint32)


def rand_u32(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, size=shape,
                                                dtype=np.uint32)


def as_words(a: np.ndarray) -> torch.Tensor:
    """u32 numpy -> port int32 words on the CPU."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())
