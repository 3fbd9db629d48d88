"""The port's cross-pod gradient compression (repro_torch.optim.compress)
against the reference's: the reference's two tests
(tests/test_optim_data_dist.py) run on the port, and the mean and the new
error feedback byte-equal to the reference's on the (2, 2, 2) pod mesh for
leaves that the pod axis splits or not, over three rounds (the error
feedback carried), and on a (4, 2, 1) mesh whose four pods make the ring's
order of additions matter."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, NamedSharding, PartitionSpec

from repro.optim.compress import init_error_feedback as ref_init
from repro.optim.compress import make_crosspod_compressed_mean as ref_mean
from repro_torch.dist.sharding import P, ZoneMesh
from repro_torch.optim.compress import (init_error_feedback,
                                        make_crosspod_compressed_mean)
from tests import _torch_ref as tr
from tests._torch_ref import compile_cache, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("compile_cache", "one_thread")


def test_crosspod_compressed_mean():
    """The reference's test: pods hold identical replicas, so the mean is
    the input up to int8 quantization error (scale = max|g| / 127), and
    the error feedback captures exactly the residual."""
    mesh = tr.zone_mesh("mesh_pod")
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 16)).astype(np.float32))
    grads = {"w": g}
    f = make_crosspod_compressed_mean(mesh, {"w": P()})
    out, new_ef = f(grads, init_error_feedback(grads))
    scale = float(g.abs().max()) / 127.0
    np.testing.assert_allclose(out["w"].numpy(), g.numpy(),
                               atol=scale + 1e-7)
    assert float(new_ef["w"].abs().max()) <= scale + 1e-7


def test_error_feedback_reduces_bias():
    """The reference's test: the sum of the dequantized outputs plus the
    final residual equals the sum of the raw gradients (telescoping)."""
    rng = np.random.default_rng(1)
    f = make_crosspod_compressed_mean(tr.zone_mesh("mesh_pod"), {"w": P()})
    g = {"w": torch.from_numpy(rng.standard_normal((4, 8)).astype(
        np.float32))}
    ef = init_error_feedback(g)
    total_out = np.zeros((4, 8), np.float32)
    total_in = np.zeros((4, 8), np.float32)
    for _ in range(5):
        out, ef = f(g, ef)
        total_out += out["w"].numpy()
        total_in += g["w"].numpy()
    np.testing.assert_allclose(total_out + ef["w"].numpy(), total_in,
                               atol=1e-4)


def raw(t: torch.Tensor) -> bytes:
    """A tensor's bytes (bf16 through its 16-bit pattern)."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16
            else t).numpy().tobytes()


def pod_meshes(shape):
    axes = ("pod", "data", "model")
    return (jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * 3),
            ZoneMesh(shape, axes))


SPECS = [(), ("data",), (("pod", "data"),), (None, "model")]


@pytest.mark.parametrize("shape", [(2, 2, 2), (4, 2, 1)])
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_byte_equal_to_the_reference(shape, spec):
    """Each block's scale from its own shard; the pods' payloads added in
    the ring's order; three rounds with the error feedback carried, every
    output and residual byte-equal (f32, and a bf16 gradient)."""
    jmesh, zmesh = pod_meshes(shape)
    rng = np.random.default_rng(7)
    # rows of very different magnitudes, so each block has its own scale
    base = rng.standard_normal((16, 32)).astype(np.float32)
    grads = {"f": base * np.geomspace(1e-3, 1e2, 16,
                                      dtype=np.float32)[:, None],
             "h": (base[::-1] * 3).copy()}
    jspecs = {k: PartitionSpec(*spec) for k in grads}
    specs = {k: P(*spec) for k in grads}
    jg = {"f": jax.device_put(jnp.asarray(grads["f"]),
                              NamedSharding(jmesh, jspecs["f"])),
          "h": jax.device_put(jnp.asarray(grads["h"], jnp.bfloat16),
                              NamedSharding(jmesh, jspecs["h"]))}
    tg = {"f": torch.from_numpy(grads["f"]),
          "h": torch.from_numpy(grads["h"]).to(torch.bfloat16)}
    ref_f = ref_mean(jmesh, jspecs)
    port_f = make_crosspod_compressed_mean(zmesh, specs)
    jef, tef = ref_init(jg), init_error_feedback(tg)
    for _ in range(3):
        jout, jef = ref_f(jg, jef)
        tout, tef = port_f(tg, tef)
        for k in grads:
            assert raw(tout[k]) == np.asarray(jout[k]).tobytes(), k
            assert raw(tef[k]) == np.asarray(jef[k]).tobytes(), k
            assert tout[k].dtype == tg[k].dtype
            assert tef[k].dtype == torch.float32


def test_error_feedback_starts_at_zero_on_the_leaf_device():
    params = {"a": torch.ones(3, 4, dtype=torch.bfloat16),
              "b": {"c": torch.ones(5)}}
    ef = init_error_feedback(params)
    assert ef["a"].dtype == torch.float32 and ef["a"].shape == (3, 4)
    assert float(ef["b"]["c"].abs().sum()) == 0.0
    assert ef["b"]["c"].device == params["b"]["c"].device
