"""The port's routed-expert FFN: gradients against `jax.grad` and the
combine's fixed summation order (tests/test_torch_moe.py's cases and
stated tolerances).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro_torch import utils
from repro_torch.models import moe
from tests import _torch_ref as tr
from tests.test_torch_hybrid import (DTYPES, F32_RTOL, GRAD, close, rand,
                                     same_grads)
from tests.test_torch_moe import cfgs, ffn_params
from tests._torch_ref import compile_cache, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("compile_cache", "one_thread")


@pytest.fixture(autouse=True)
def _f32_dots(monkeypatch):
    tr.f32_dots(monkeypatch, ref_moe)

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["moonshot-v1-16b-a3b", "moe_top2"])
def test_gradients(case, dtype):
    """The output through a fixed read-out plus the aux values: gradients
    with respect to every FFN parameter (router, expert stacks, shared
    expert) and the input, by autograd against `jax.grad`, routed in the
    (4, 2) mesh's groups."""
    ref_cfg, cfg = cfgs(case, dtype)
    jp, _ = ffn_params(ref_cfg)
    p = jax.tree.map(np.asarray, jp)
    x = np.random.default_rng(4).standard_normal(
        (4, 6, cfg.d_model)).astype(np.float32)
    w = np.linspace(-1, 1, cfg.d_model).astype(np.float32)
    jmesh, zmesh = tr.jax_mesh("mesh42"), tr.zone_mesh("mesh42")

    def f(p, x):
        out, aux = ref_moe.apply_moe(p, x.astype(dtype), ref_cfg, jmesh)
        return (jnp.sum(out.astype(jnp.float32) * w) + aux["load_balance"]
                + aux["router_z"])
    with jax.disable_jit(dtype == "bfloat16"):
        want, (wgp, wgx) = jax.value_and_grad(f, argnums=(0, 1))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = utils.tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(), p)
    xt = torch.from_numpy(x.copy()).requires_grad_()
    out, aux = moe.apply_moe(tp, xt.to(moe.L.cdt(cfg)), cfg, zmesh)
    got = ((out.float() * torch.from_numpy(w)).sum() + aux["load_balance"]
           + aux["router_z"])
    got.backward()
    tol = GRAD[dtype]
    close(got, want, tol["loss"] if dtype == "bfloat16" else F32_RTOL)
    same_grads([t.grad for t in utils.tree_leaves(tp)],
               jax.tree.leaves(wgp), tol)
    same_grads([xt.grad], [wgx], tol)


def test_combine_gives_equal_bits_every_run():
    """The combine sums each token's copies in one order: two runs, and a
    run on permuted copies of the same routing, give the same bits."""
    ref_cfg, cfg = cfgs("moonshot-v1-16b-a3b")
    _, pp = ffn_params(ref_cfg)
    _, xt = rand((2, 32, cfg.d_model), 5)
    runs = []
    for _ in range(3):
        out, _ = moe.apply_moe(pp, xt, cfg, tr.zone_mesh("mesh42"))
        runs.append(out.numpy().tobytes())
    assert runs[0] == runs[1] == runs[2]


def test_combine_adds_in_the_sorted_order():
    """A token's k contributions summed in the order the reference's
    scatter-add meets them: `_combine_group` bit-equal to the reference's
    on the same expert outputs."""
    ref_cfg, cfg = cfgs("moonshot-v1-16b-a3b")
    jp, pp = ffn_params(ref_cfg)
    m = cfg.moe
    x, xt = rand((1, 24, cfg.d_model), 6)
    cap = 8
    route = moe._route_group(xt, pp["router"], m.num_experts, m.top_k, cap,
                             torch.float32)
    y, yt = rand((1, m.num_experts, cap, cfg.d_model), 7)
    slot, src, gate, order = (np.asarray(route[i].numpy()[0])
                              for i in (1, 2, 3, 4))
    want = ref_moe._combine_group(y[0], jnp.asarray(slot), jnp.asarray(src),
                                  jnp.asarray(gate), jnp.asarray(order), 24,
                                  cfg.d_model, jnp.float32)
    got = moe._combine_group(yt, route[1], route[4], route[3], m.top_k,
                             torch.float32)
    assert got[0].numpy().tobytes() == np.asarray(want).tobytes()
