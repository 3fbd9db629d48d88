"""The port's hybrid family (repro_torch.models.rglru, the `attn` and
`rglru` blocks, the unstacked tail blocks) against the reference's, on
the same numpy inputs at reduced sizes (recurrentgemma-2b's `reduced()`:
5 layers over the pattern (rglru, rglru, attn), so one group and a tail
of two rglru blocks; window 16).  The whole model (loss, gradients,
decode) is in tests/test_torch_hybrid_model.py.

Tolerances, as a share of the reference's largest magnitude: f32 within
1e-5 for every module and block (the port's scan is the reference's
recursion, so it is bit-equal on the same (a, b)), the module's
gradients as tests/test_torch_train_model.py holds them (2e-5 and a
cosine of 1 - 1e-9); bf16 within 2^-7 for modules and blocks (a bf16
product summed in another order lands one unit apart), the module's
gradients as test_torch_train_model.py's bf16 (2^-5, cosine 0.999).
Specs, counts and caches' shapes are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import registry as ref_registry
from repro.configs.base import ModelConfig as RefModelConfig
from repro.models import api as ref_api
from repro.models import blocks as ref_blocks
from repro.models import rglru as ref_rglru
from repro.models.transformer import build_model as ref_build
from repro_torch import convert, utils
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api, blocks, rglru
from repro_torch.models import params as prm
from repro_torch.models.transformer import build_model
from tests import _torch_ref as tr
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = "recurrentgemma-2b"
F32_RTOL = 1e-5
BF16_RTOL = 2 ** -7
GRAD = {"float32": {"loss": 1e-6, "grad": 2e-5, "cos": 1 - 1e-9},
        "bfloat16": {"loss": 1e-4, "grad": 2 ** -5, "cos": 0.999}}
DTYPES = ("float32", "bfloat16")


def cfgs(dtype, **kw):
    ref = dataclasses.replace(ref_registry.get_config(ARCH, reduced=True),
                              compute_dtype=dtype, **kw)
    port = dataclasses.replace(registry.get_config(ARCH, reduced=True),
                               compute_dtype=dtype, **kw)
    return ref, port


def rtol(dtype):
    return F32_RTOL if dtype == "float32" else BF16_RTOL


def ref_params(ref_cfg, seed=0):
    """The reference's parameters (numpy) with every zero- or one-init
    leaf redrawn at random, so biases and norm scales are exercised."""
    params = ref_build(ref_cfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def redraw(x):
        x = np.asarray(x)
        if np.all(x == x.flat[0]):
            x = (1 + 0.3 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree.map(redraw, params)


def rand(shape, seed, dtype="float32", scale=1.0):
    x = jnp.asarray((np.random.default_rng(seed).standard_normal(shape)
                     * scale).astype(np.float32)).astype(dtype)
    return x, convert._leaf(np.asarray(x), "cpu")


def both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            convert.params_to_port(tree, "cpu"))


def close(got, want, tol):
    want = np.asarray(jnp.asarray(want, jnp.float32)).astype(np.float64)
    got = got.detach().float().numpy().astype(np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), err


def same_grads(got, want, tol):
    for a, b in zip(utils.tree_leaves(got), jax.tree.leaves(want),
                    strict=True):
        x = a.double().reshape(-1).numpy()
        y = np.asarray(b, np.float64).reshape(-1)
        assert x @ y / np.linalg.norm(x) / np.linalg.norm(y) >= tol["cos"]
        close(a, b, tol["grad"])


def rec_params(ref_cfg, key="b0_rglru"):
    """Layer 0's RG-LRU parameters, (jnp tree, port tree)."""
    p = jax.tree.map(lambda x: x[0], ref_params(ref_cfg)["groups"][key])
    return both(p["rec"])


# -- rglru ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 40])
def test_scan_is_the_associative_scan_bit_for_bit(n):
    a = np.random.default_rng(n).uniform(0.5, 1.0, (2, n, 6))
    b = np.random.default_rng(n + 1).standard_normal((2, n, 6))
    a, b = a.astype(np.float32), b.astype(np.float32)

    def combine(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]
    wa, wb = lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)),
                                  axis=1)
    ga, gb = rglru._scan(torch.from_numpy(a), torch.from_numpy(b))
    assert ga.numpy().tobytes() == np.asarray(wa).tobytes()
    assert gb.numpy().tobytes() == np.asarray(wb).tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
def test_gates(dtype):
    ref_cfg, _ = cfgs(dtype)
    jp, pp = rec_params(ref_cfg)
    u, ut = rand((3, 7, ref_cfg.d_model), 1, dtype, scale=3.0)
    for got, want in zip(rglru._gates(pp, ut), ref_rglru._gates(jp, u)):
        assert got.dtype == torch.float32
        close(got, want, F32_RTOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_softplus_is_logaddexp(dtype):
    x = np.array([-100.0, -20.5, -1.0, 0.0, 0.3, 19.0, 21.0, 80.0],
                 np.float32)
    got = rglru._softplus(torch.from_numpy(x))
    want = jax.nn.softplus(jnp.asarray(x))
    close(got, want, F32_RTOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_train(dtype):
    ref_cfg, _ = cfgs(dtype)
    jp, pp = rec_params(ref_cfg)
    x, xt = rand((2, 9, ref_cfg.d_model), 2, dtype)
    got = rglru._conv_train(pp, xt)
    assert got.dtype == xt.dtype
    close(got, ref_rglru._conv_train(jp, x), rtol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_train_and_gradients(dtype):
    """The block's recurrence forward and its gradients with respect to
    every parameter and the input, through a fixed linear read-out."""
    ref_cfg, cfg = cfgs(dtype)
    p = jax.tree.map(lambda x: x[0], ref_params(ref_cfg)["groups"][
        "b0_rglru"])["rec"]
    x = np.random.default_rng(3).standard_normal(
        (2, 33, ref_cfg.d_model)).astype(np.float32)
    w = np.linspace(-1, 1, ref_cfg.d_model).astype(np.float32)

    def f(p, x):
        out = ref_rglru.apply_train(p, x.astype(dtype), ref_cfg)
        return jnp.sum(out.astype(jnp.float32) * w)
    want, (wgp, wgx) = jax.value_and_grad(f, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in p.items()}
    xt = torch.from_numpy(x.copy()).requires_grad_()
    out = rglru.apply_train(tp, xt.to(rglru.L.cdt(cfg)), cfg)
    assert out.dtype == rglru.L.cdt(cfg)
    got = (out.float() * torch.from_numpy(w)).sum()
    got.backward()
    tol = GRAD[dtype]
    close(got, want, tol["loss"] if dtype == "bfloat16" else F32_RTOL)
    same_grads({k: tp[k].grad for k in sorted(tp)},
               {k: wgp[k] for k in sorted(p)}, tol)
    same_grads([xt.grad], [wgx], tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_cache_and_apply_decode(dtype):
    """Five O(1) steps from the empty state: the output, the conv history
    (bit for bit) and the f32 state."""
    ref_cfg, cfg = cfgs(dtype)
    jp, pp = rec_params(ref_cfg, "b1_rglru")
    jc = ref_rglru.init_cache(ref_cfg, 3)
    pc = rglru.init_cache(cfg, 3, "cpu")
    for n in jc:
        assert convert._np_leaf(pc[n]).tobytes() == \
            np.asarray(jc[n]).tobytes()
    x, xt = rand((3, 5, ref_cfg.d_model), 4, dtype)
    for t in range(5):
        want, jc = ref_rglru.apply_decode(jp, x[:, t:t + 1], jc, ref_cfg)
        mine = {n: v.clone() for n, v in pc.items()}
        got, pc = rglru.apply_decode(pp, xt[:, t:t + 1], mine, cfg)
        assert pc["conv"] is mine["conv"] and pc["h"] is mine["h"]
        close(got, want, rtol(dtype))
        assert pc["h"].dtype == torch.float32
        close(pc["h"], jc["h"], F32_RTOL)
        # the history is the steps' own u, shifted: bit for bit when the
        # projections agree, within a unit at bf16
        close(pc["conv"], jc["conv"], rtol(dtype))


# -- blocks ---------------------------------------------------------------------

def slot_positions(T, pos, window=None):
    sp = np.full((T,), -1, np.int32)
    for p in range(pos):
        sp[p % T if window else p] = p
    return sp


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("key", ["b0_rglru", "b2_attn", "tail1_rglru"])
def test_block_apply_train(key, dtype):
    ref_cfg, cfg = cfgs(dtype)
    np_params = ref_params(ref_cfg)
    bt = key.split("_", 1)[1]
    p = (np_params[key] if key.startswith("tail")
         else jax.tree.map(lambda x: x[0], np_params["groups"][key]))
    jp, pp = both(p)
    S = 40                      # past the window: the mask cuts old keys
    x, xt = rand((2, S, cfg.d_model), 5, dtype)
    want, _ = ref_blocks.apply_train(jp, bt, x, ref_cfg,
                                     positions=jnp.arange(S))
    got, aux = blocks.apply_train(pp, bt, xt, cfg,
                                  positions=torch.arange(S))
    assert aux == {}
    close(got, want, rtol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("key", ["b1_rglru", "b2_attn"])
def test_block_apply_decode(key, dtype):
    """One step into a cache holding earlier steps: the attn block's
    window ring (T = window 16) at positions before and after it wraps."""
    ref_cfg, cfg = cfgs(dtype)
    bt = key.split("_", 1)[1]
    jp, pp = both(jax.tree.map(lambda x: x[0],
                               ref_params(ref_cfg)["groups"][key]))
    B = 3
    jc = ref_blocks.init_cache(ref_cfg, bt, B, 24)
    pc = blocks.init_cache(cfg, bt, B, 24, "cpu")
    assert {n: tuple(v.shape) for n, v in pc.items()} == \
        {n: v.shape for n, v in jc.items()}
    if bt == "attn":
        assert jc["k"].shape[1] == cfg.window == 16
    for pos in (7, 16, 29):
        cache = {}
        for i, (n, v) in enumerate(sorted(jc.items())):
            if n == "pos":
                cache[n] = (jnp.asarray(slot_positions(16, pos, True)),
                            torch.from_numpy(slot_positions(16, pos, True)))
            else:
                cache[n] = rand(v.shape, 10 + i, v.dtype)
        jcache = {n: a for n, (a, _) in cache.items()}
        mine = {n: t.clone() for n, (_, t) in cache.items()}
        x, xt = rand((B, 1, cfg.d_model), 6, dtype)
        want_x, want_c = ref_blocks.apply_decode(
            jp, bt, x, jcache, jnp.asarray(pos, jnp.int32), ref_cfg)
        got_x, got_c = blocks.apply_decode(
            pp, bt, xt, mine, pos, cfg,
            blocks.decode_positions(pos, cfg, "cpu"))
        close(got_x, want_x, rtol(dtype))
        for n in want_c:
            assert got_c[n] is mine[n]
            tol = F32_RTOL if n == "h" else rtol(dtype)
            close(got_c[n], want_c[n], tol)
        if bt == "attn":
            assert convert._np_leaf(got_c["pos"]).tobytes() == \
                np.asarray(want_c["pos"]).tobytes()


# -- the model ------------------------------------------------------------------

def _spec_pairs(ref_tree, port_tree):
    ref_leaves = jax.tree.leaves(
        ref_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return zip(ref_leaves, utils.tree_leaves(port_tree), strict=True)


@pytest.mark.parametrize("mesh_name", ["mesh42", "mesh81"])
@pytest.mark.parametrize("reduced", [False, True])
def test_param_defs_and_specs_match_the_reference(reduced, mesh_name):
    """Every parameter and cache leaf, the tail's unstacked ones included:
    the same tree, shapes, dtypes and partition specs (MQA's single KV
    head puts the cache's sequence dim on `model` at (4, 2))."""
    mesh, zmesh = tr.jax_mesh(mesh_name), tr.zone_mesh(mesh_name)
    ref_m = ref_build(ref_registry.get_config(ARCH, reduced=reduced), mesh)
    port_m = build_model(registry.get_config(ARCH, reduced=reduced), zmesh)
    assert port_m.tail == ref_m.tail == ("rglru", "rglru")
    ref_abs = ref_m.abstract_params()
    port_abs = prm.abstract_params(port_m.param_defs())
    assert sorted(port_abs) == sorted(ref_abs)
    assert sorted(port_abs["groups"]) == sorted(ref_abs["groups"])
    for want, got in zip(jax.tree.leaves(ref_abs),
                         utils.tree_leaves(port_abs), strict=True):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype) == f"torch.{want.dtype}"
    for want, got in _spec_pairs(ref_m.param_specs(mesh),
                                 port_m.param_specs(zmesh)):
        assert tuple(got) == tuple(want)
    ref_cache = jax.eval_shape(lambda: ref_m.init_cache(16, 2048))
    port_cache = port_m.init_cache(16, 2048, device="meta")
    assert sorted(port_cache) == sorted(ref_cache) == [
        "groups", "tail0_rglru", "tail1_rglru"]
    for want, got in zip(jax.tree.leaves(ref_cache),
                         utils.tree_leaves(port_cache), strict=True):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype) == f"torch.{want.dtype}"
    for want, got in _spec_pairs(ref_m.cache_specs(16, 2048, mesh),
                                 port_m.cache_specs(16, 2048, zmesh)):
        assert tuple(got) == tuple(want)


@pytest.mark.parametrize("arch,count", [("recurrentgemma-2b", 2_658_736_640),
                                        ("chameleon-34b", 34_293_436_416)])
def test_count_params(arch, count):
    ref = ref_registry.get_config(arch)
    port = registry.get_config(arch)
    assert api.count_params(port) == ref_api.count_params(ref) == count
    assert port.param_count() == ref.param_count()


# -- the reference's own family tests (tests/test_models.py) --------------------

T_RG = dict(name="t_rg", family="hybrid", block_pattern=("rglru", "rglru",
                                                          "attn"),
            window=8, subquadratic=True, n_layers=5, d_model=64, n_heads=4,
            n_kv=1, d_ff=128, vocab=256, param_dtype="float32",
            compute_dtype="float32")


def test_decode_matches_forward():
    """tests/test_models.py's hybrid case on the port: greedy decode
    logits at position t equal the forward's at t (rel 1e-4), with the
    reference's parameters."""
    cfg = ModelConfig(**T_RG)
    model = build_model(cfg)
    params = convert.params_to_port(jax.tree.map(
        np.asarray, ref_build(RefModelConfig(**T_RG)).init(
            jax.random.PRNGKey(0))), "cpu")
    B, T, n_check = 2, 16, 8
    tok = torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(2), (B, T), 0, cfg.vocab)))
    cache = model.init_cache(B, T, "cpu")
    logits = []
    for t in range(n_check):
        lg, cache = model.decode_step(params, tok[:, t], cache, t)
        logits.append(lg)
    dec = torch.stack(logits, 1)
    with torch.no_grad():
        fwd, _ = model.forward(params, {"tokens": tok[:, :n_check]})
    rel = float((dec - fwd).abs().max()) / (float(fwd.abs().max()) + 1e-9)
    assert rel < 1e-4, rel


def test_sliding_window_masks_old_tokens():
    """tests/test_models.py's case: one `attn` layer of window 4; changing
    token 0 leaves the logits at positions >= 4 unchanged."""
    cfg = ModelConfig(name="t_win", family="dense", n_layers=1, d_model=64,
                      n_heads=4, n_kv=2, d_ff=128, vocab=256,
                      param_dtype="float32", compute_dtype="float32",
                      window=4, block_pattern=("attn",))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tok = torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(3), (1, 16), 0, cfg.vocab)))
    tok2 = tok.clone()
    tok2[0, 0] = (tok[0, 0] + 1) % cfg.vocab
    with torch.no_grad():
        lg1, _ = model.forward(params, {"tokens": tok})
        lg2, _ = model.forward(params, {"tokens": tok2})
    d = (lg1 - lg2).abs()[0]
    assert float(d[4:].max()) < 1e-5, "token 0 leaked past the window"
    assert float(d[0].max()) > 0, "sanity: position 0 must differ"
