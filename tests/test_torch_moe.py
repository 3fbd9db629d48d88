"""The port's routed-expert FFN (repro_torch.models.moe) against the
reference's, on the same numpy inputs: the routing of a group
(`_route_group`: expert choices, gates, the sorted order, slots, the kept
mask, the dispatch buffer), the combine, and `apply_moe` with its three
aux values, at moonshot's and maverick's `reduced()`
widths and at the tests/test_models.py families moe_top1 and moe_top2.
The groups come from the mesh ((4, 2): 4 data shards) in training and
are one with the whole group as capacity when decoding.

Tolerances: the routing's integer outputs (expert indices, order, slots,
kept mask, the dispatch rows' tokens) exactly; f32 float math within
F32_RTOL = 1e-5 of the reference's largest magnitude, elementwise
within rtol 1e-5 / atol 1e-6 for the gates and probabilities; bf16
within 2^-7.  The gradients and the combine's fixed order are in
tests/test_torch_moe_grads.py.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import MoESpec as RefMoESpec
from repro.models import moe as ref_moe
from repro.models.transformer import build_model as ref_build
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, MoESpec
from repro_torch.models import moe
from tests import _torch_ref as tr
from tests.test_torch_hybrid import (BF16_RTOL, DTYPES, F32_RTOL, both, close,
                                     rand)
from tests._torch_ref import compile_cache, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("compile_cache", "one_thread")

COMMON = dict(n_layers=4, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
              param_dtype="float32", compute_dtype="float32")
FAMILIES = {   # tests/test_models.py's moe families
    "moe_top1": dict(name="t_moe1", family="moe", moe=dict(
        num_experts=4, top_k=1, d_expert=128, interleave=2,
        shared_expert=True, capacity_factor=4.0)),
    "moe_top2": dict(name="t_moe2", family="moe", moe=dict(
        num_experts=4, top_k=2, d_expert=128, capacity_factor=4.0)),
}
ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b")
CASES = ARCHS + tuple(FAMILIES)


@pytest.fixture(autouse=True)
def _f32_dots(monkeypatch):
    tr.f32_dots(monkeypatch, ref_moe)


def cfgs(case, dtype="float32", **moe_kw):
    """(reference config, port config) of an arch's reduced() or a
    test_models family, at `dtype`, the MoESpec's fields replaced."""
    if case in FAMILIES:
        f = dict(FAMILIES[case])
        spec = dict(f.pop("moe"), **moe_kw)
        ref = RefModelConfig(**COMMON, **f, moe=RefMoESpec(**spec))
        port = ModelConfig(**COMMON, **f, moe=MoESpec(**spec))
    else:
        ref = ref_registry.get_config(case, reduced=True)
        port = registry.get_config(case, reduced=True)
        ref = dataclasses.replace(
            ref, moe=dataclasses.replace(ref.moe, **moe_kw))
        port = dataclasses.replace(
            port, moe=dataclasses.replace(port.moe, **moe_kw))
    return (dataclasses.replace(ref, compute_dtype=dtype),
            dataclasses.replace(port, compute_dtype=dtype))


def ffn_params(ref_cfg, seed=0):
    """A moe block's FFN parameters, (jnp tree, port tree): the
    reference's init, the router scaled up so the probabilities spread."""
    model = ref_build(ref_cfg)
    key = next(k for k in model.pattern if k == "moe")
    j = [i for i, t in enumerate(model.pattern) if t == key][0]
    params = model.init(jax.random.PRNGKey(seed))
    p = jax.tree.map(lambda x: np.asarray(x[0]),
                     params["groups"][f"b{j}_moe"]["ffn"])
    p["router"] = p["router"] * 50.0
    return both(p)


def check_route(got, want, G):
    names = ("h", "slot", "src_token", "flat_gate", "order", "keep",
             "probs", "flat_expert", "logits")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        g = g.detach()
        assert tuple(g.shape) == (G,) + w.shape[1:], name
        if name in ("slot", "src_token", "order", "keep", "flat_expert"):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        elif name == "h":
            # the dispatch rows are the tokens' own values
            assert g.float().numpy().tobytes() == \
                w.astype(np.float32).tobytes(), name
        else:
            tr.allclose(g, w)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("capacity", [1, 3, 64])
def test_route_group_matches_the_reference(case, capacity):
    """Every field of the routing of G = 4 groups of 16 tokens, against
    the reference's per group; capacity 1 and 3 drop copies."""
    ref_cfg, cfg = cfgs(case)
    jp, pp = ffn_params(ref_cfg)
    m = cfg.moe
    x, xt = rand((4, 16, cfg.d_model), 1)
    got = moe._route_group(xt, pp["router"], m.num_experts, m.top_k,
                           capacity, torch.float32)
    want = jax.vmap(lambda a: ref_moe._route_group(
        a, jp["router"], m.num_experts, m.top_k, capacity, jnp.float32))(x)
    check_route(got, want, 4)
    kept = got[5].float().mean()
    assert (kept < 1) == (capacity * m.num_experts < 16 * m.top_k)


def test_top_k_breaks_ties_toward_the_lower_index():
    """Equal probabilities: `lax.top_k`'s choice, the lower expert."""
    rng = np.random.default_rng(2)
    probs = rng.integers(0, 3, (64, 8)).astype(np.float32) / 4
    for k in (1, 2, 6):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = moe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("shape,want", [((4, 2), 4), ((8, 1), 8),
                                        ((2, 2, 2), 4)])
def test_groups_come_from_the_mesh(shape, want):
    """pod x data shards, as the reference's, or one group when they do
    not divide the tokens or there is no mesh."""
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
    name = {(4, 2): "mesh42", (8, 1): "mesh81", (2, 2, 2): "mesh_pod"}[shape]
    zm, jm = tr.zone_mesh(name), tr.jax_mesh(name)
    assert tuple(zm.axis_names) == axes
    for T in (want * 3, want * 3 + 1, 1):
        assert moe._n_groups(zm, T) == ref_moe._n_groups(jm, T)
    assert moe._n_groups(zm, want * 3) == want
    assert moe._n_groups(None, 64) == ref_moe._n_groups(None, 64) == 1


def run_moe(case, dtype, S, mesh_name, seed=3, **moe_kw):
    ref_cfg, cfg = cfgs(case, dtype, **moe_kw)
    jp, pp = ffn_params(ref_cfg)
    x, xt = rand((4, S, cfg.d_model), seed, dtype)
    jmesh = tr.jax_mesh(mesh_name) if mesh_name else None
    zmesh = tr.zone_mesh(mesh_name) if mesh_name else None
    with jax.disable_jit(dtype == "bfloat16"):
        want, waux = ref_moe.apply_moe(jp, x, ref_cfg, jmesh)
    got, aux = moe.apply_moe(pp, xt, cfg, zmesh)
    return got, aux, want, waux, cfg


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_apply_moe_in_the_meshs_groups(case, dtype):
    """A training forward routed in the (4, 2) mesh's 4 groups: the
    output and the aux values (load balance, router z, dropped share)."""
    got, aux, want, waux, _ = run_moe(case, dtype, 8, "mesh42")
    assert got.dtype == {"float32": torch.float32,
                         "bfloat16": torch.bfloat16}[dtype]
    close(got, want, F32_RTOL if dtype == "float32" else BF16_RTOL)
    assert sorted(aux) == sorted(waux)
    for k in waux:
        close(aux[k], waux[k], F32_RTOL)


@pytest.mark.parametrize("case", CASES)
def test_dropped_tokens(case):
    """At capacity factor 0.3 copies are dropped: the same share as the
    reference's, and the same output (dropped copies add zeros)."""
    got, aux, want, waux, _ = run_moe(case, "float32", 8, "mesh42",
                                      capacity_factor=0.3)
    assert float(aux["dropped_fraction"]) > 0
    assert float(aux["dropped_fraction"]) == \
        float(waux["dropped_fraction"])
    close(got, want, F32_RTOL)


@pytest.mark.parametrize("case", CASES)
def test_decode_routes_one_group_without_dropping(case):
    """S = 1: one group whatever the mesh, capacity the whole group (at
    capacity factor 0.3, which would drop in training): no copy dropped,
    the reference's output."""
    got, aux, want, waux, cfg = run_moe(case, "float32", 1, None,
                                        capacity_factor=0.3)
    assert float(aux["dropped_fraction"]) == 0.0 == \
        float(waux["dropped_fraction"])
    close(got, want, F32_RTOL)
    m = cfg.moe
    assert max(int(math.ceil(4 * m.top_k / m.num_experts * 0.3)), 1) < 4
