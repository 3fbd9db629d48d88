"""The encoder-decoder family (seamless-m4t-large-v2's `reduced()`: 2 + 2
layers, 4 heads and 4 KV heads of 16, and tests/test_models.py's encdec
family: GQA, 4 heads on 2 KV heads) against the reference's: the `enc`
and `dec_x` blocks' train and decode, `encode`, `build_cross_cache`,
forward, loss and gradients (the encoder's leaves included), a source
longer than the target, the stepped decode over a built cross cache,
bf16, `count_params`; and chip_smoke's es h / et i checks on the CPU,
each passing the port and catching a planted fault.

At the reference's init the (d, heads, head_dim) projections take
`heads` as their fan-in (ROADMAP queue C): the cross attention reads the
encoder's normed output, so its scores have a std of ~65 at reduced
width and the softmax is one-hot, and the last-bit differences of two
f32 sums grow through it (the reduced forward's logits 4e-4 of the
largest apart, the block alone 7e-6).  So the model-level f32 checks run
on `chip_smoke.soft_attention`'s weights, as the card's es and et do,
where the same forward sits 5e-7 apart:

  * f32: blocks, encode, cross cache, forward and decode logits within
    F32 = 1e-5 of the reference's largest |value|; the loss within
    1e-6; gradients at a cosine of 1 - 1e-9 a leaf and within 2e-5 of
    the leaf's largest |gradient| (tests/test_torch_train_model.py's
    F32_RTOL).
  * bf16: the reference run op by op (`jax.disable_jit`): the loss
    within 1e-4, gradients at a cosine of 0.995 a leaf and a norm within
    5% of the reference's (tests/test_torch_hybrid_model.py's bounds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.base import ModelConfig as RefModelConfig
from repro.models import blocks as ref_blocks
from repro.models.transformer import build_model as ref_build
from repro_torch import convert, utils
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api, blocks
from repro_torch.models.transformer import EncDecModel, build_model
from tests._torch_ref import one_thread  # noqa: F401

import chip_smoke

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = "seamless-m4t-large-v2"
ENCDEC = dict(name="t_ed", family="audio", enc_layers=2, n_layers=2,
              d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
              param_dtype="float32", compute_dtype="float32")
CASES = ("reduced", "encdec")
F32 = 1e-5
F32_GRAD = {"loss": 1e-6, "grad": 2e-5, "cos": 1 - 1e-9}
BF16_LOSS, BF16_COS, BF16_NORM = 1e-4, 0.995, 0.05
B, S = 2, 16


def cfgs(case, dtype="float32"):
    if case == "reduced":
        ref = ref_registry.get_config(ARCH, reduced=True)
        port = registry.get_config(ARCH, reduced=True)
    else:
        ref, port = RefModelConfig(**ENCDEC), ModelConfig(**ENCDEC)
    return (dataclasses.replace(ref, compute_dtype=dtype),
            dataclasses.replace(port, compute_dtype=dtype))


def soft(ref_cfg, seed=0, scale=True):
    """The reference's init from `seed`, its attention projections scaled
    by `chip_smoke.soft_attention` (unless `scale` is False): (the
    reference's tree, the port's)."""
    params = ref_build(ref_cfg).init(jax.random.PRNGKey(seed))
    pp = convert.params_to_port(jax.tree.map(np.asarray, params), "cpu")
    if scale:
        chip_smoke.soft_attention(pp)
    return (jax.tree.map(jnp.asarray,
                         utils.tree_map(convert._np_leaf, pp)), pp)


def inputs(cfg, src_len=S, seed=1):
    """Seeded tokens (B, S) and a source (B, src_len, D) of the synthetic
    stream's scale (std 0.02), as numpy."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    src = (rng.standard_normal((B, src_len, cfg.d_model)) * 0.02).astype(
        np.float32)
    return tok, src


def batches(tok, src):
    return ({"tokens": jnp.asarray(tok), "src_embeds": jnp.asarray(src)},
            {"tokens": torch.from_numpy(tok),
             "src_embeds": torch.from_numpy(src)})


def close(got, want, rtol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * max(float(np.abs(want).max()), 1e-30), err


def same_grads(got, want, tol):
    for a, b in zip(utils.tree_leaves(got), jax.tree.leaves(want),
                    strict=True):
        x = a.double().reshape(-1).numpy()
        y = np.asarray(b, np.float64).reshape(-1)
        assert x @ y / np.linalg.norm(x) / np.linalg.norm(y) >= tol["cos"]
        close(a, b, tol["grad"])


def layer(tree, key, i=0):
    return tree["groups" if key == "b0_dec_x" else "enc_groups"][key]


@pytest.mark.parametrize("btype", ["enc", "dec_x"])
def test_block_train(btype):
    """One block on a seeded input (a dec_x block's source 24 long, the
    target 16): the output within F32."""
    ref_cfg, cfg = cfgs("encdec")
    rp, pp = soft(ref_cfg)
    key = f"b0_{btype}"
    r_blk = jax.tree.map(lambda w: w[0], layer(rp, key))
    p_blk = utils.tree_map(lambda w: w[0], layer(pp, key))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 24, cfg.d_model)).astype(np.float32)
    want, _ = ref_blocks.apply_train(
        r_blk, btype, jnp.asarray(x), ref_cfg, positions=jnp.arange(S),
        enc_out=jnp.asarray(enc), causal=btype != "enc")
    got, aux = blocks.apply_train(
        p_blk, btype, torch.from_numpy(x), cfg, positions=torch.arange(S),
        enc_out=torch.from_numpy(enc))
    assert aux == {}
    close(got, want, F32)


def test_block_types_and_defs():
    """`dec_x` adds `lnx` and a bias-free `xattn` to a dense block's
    leaves; an unknown type raises ValueError."""
    cfg = dataclasses.replace(cfgs("encdec")[1], qkv_bias=True)
    dense, dec = blocks.block_defs(cfg, "dense"), blocks.block_defs(
        cfg, "dec_x")
    assert set(dec) == set(dense) | {"lnx", "xattn"}
    assert set(dec["xattn"]) == {"wq", "wk", "wv", "wo"}
    assert "bq" in dec["attn"]
    assert set(blocks.block_defs(cfg, "enc")) == set(dense)
    assert blocks.init_cache(cfg, "dec_x", 2, 8, "cpu")["k"].shape == (
        2, 8, cfg.n_kv, cfg.hd)
    with pytest.raises(ValueError):
        blocks.block_defs(cfg, "conformer")
    assert not hasattr(blocks, "LATER")


def test_block_decode_reads_the_cross_cache():
    """A dec_x block's decode at position 5 over a seeded self cache
    (slots 0-4 filled) and a cross cache of 24 slots: the output and the
    new self cache within F32 (the written slot: the step's own k, v)."""
    ref_cfg, cfg = cfgs("encdec")
    rp, pp = soft(ref_cfg)
    r_blk = jax.tree.map(lambda w: w[0], layer(rp, "b0_dec_x"))
    p_blk = utils.tree_map(lambda w: w[0], layer(pp, "b0_dec_x"))
    rng = np.random.default_rng(4)
    K, hd, T = cfg.n_kv, cfg.hd, 12
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, T, K, hd)).astype(np.float32)
              for _ in range(2))
    pos_c = np.where(np.arange(T) < 5, np.arange(T), -1).astype(np.int32)
    xk, xv = (rng.standard_normal((B, 24, K, hd)).astype(np.float32)
              for _ in range(2))
    want, wc = ref_blocks.apply_decode(
        r_blk, "dec_x", jnp.asarray(x),
        {"k": jnp.asarray(kc), "v": jnp.asarray(vc),
         "pos": jnp.asarray(pos_c)}, jnp.asarray(5, jnp.int32), ref_cfg,
        cross_cache={"k": jnp.asarray(xk), "v": jnp.asarray(xv)})
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(
        vc.copy()), "pos": torch.from_numpy(pos_c.copy())}
    cross = {"k": torch.from_numpy(xk), "v": torch.from_numpy(xv)}
    got, gc = blocks.apply_decode(
        p_blk, "dec_x", torch.from_numpy(x), cache, 5, cfg,
        blocks.decode_positions(5, cfg, "cpu"), cross_cache=cross)
    close(got, want, F32)
    for n in ("k", "v"):
        close(gc[n], wc[n], F32)
    np.testing.assert_array_equal(gc["pos"].numpy(), np.asarray(wc["pos"]))
    np.testing.assert_array_equal(cross["k"].numpy(), xk)


@pytest.mark.parametrize("case", CASES)
def test_encode_and_cross_cache(case):
    """`encode` (the source cast, the stack, `enc_norm`) and
    `build_cross_cache` (n_layers, B, S_src, K, hd) within F32."""
    ref_cfg, cfg = cfgs(case)
    rp, pp = soft(ref_cfg)
    _, src = inputs(cfg, src_len=24)
    ref_model, model = ref_build(ref_cfg), build_model(cfg)
    assert isinstance(model, EncDecModel)
    want = ref_model.encode(rp, jnp.asarray(src))
    with torch.no_grad():
        got = model.encode(pp, torch.from_numpy(src))
        close(got, want, F32)
        cross = model.build_cross_cache(pp, got)
    wcross = ref_model.build_cross_cache(rp, want)
    for n in ("k", "v"):
        assert tuple(cross[n].shape) == (cfg.n_layers, B, 24, cfg.n_kv,
                                         cfg.hd)
        close(cross[n], wcross[n], F32)


@pytest.mark.parametrize("src_len", [S, 24])
@pytest.mark.parametrize("case", CASES)
def test_loss_and_gradients_match_the_reference(case, src_len):
    """f32 loss and every gradient against `jax.grad`, the encoder's
    stacked leaves included (each group checkpointed: the decoder's
    groups read the encoder's output as an input); a source longer than
    the target too."""
    ref_cfg, cfg = cfgs(case)
    rp, pp = soft(ref_cfg)
    rb, pb = batches(*inputs(cfg, src_len=src_len))
    (want, wm), wg = jax.jit(jax.value_and_grad(
        ref_build(ref_cfg).loss, has_aux=True))(rp, rb)
    got, gm, gg = api.make_loss_and_grads(build_model(cfg))(pp, pb)
    close(got, want, F32_GRAD["loss"])
    for k in ("ce", "z_loss"):
        close(gm[k], wm[k], F32_GRAD["loss"])
    assert float(gm["aux"]) == float(wm["aux"]) == 0.0
    same_grads(gg, wg, F32_GRAD)
    for g in utils.tree_leaves(gg["enc_groups"]):
        assert bool(g.abs().max() > 0)


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_the_reference(case):
    ref_cfg, cfg = cfgs(case)
    rp, pp = soft(ref_cfg)
    rb, pb = batches(*inputs(cfg, src_len=24))
    with torch.no_grad():
        got, aux = build_model(cfg).forward(pp, pb)
        prefill = api.make_prefill(build_model(cfg))(pp, pb)
    want, _ = ref_build(ref_cfg).forward(rp, rb)
    close(got, want, F32)
    close(prefill, np.asarray(want)[:, -1], F32)


def test_the_inits_cross_attention_is_one_hot():
    """At the reference's init the reduced model's cross attention gives
    each query one source position (the mean largest softmax weight
    above 0.9); on `soft_attention`'s weights it spreads (below 0.5)."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    _, cfg = cfgs("reduced")
    tok, src = inputs(cfg, src_len=24)
    model = build_model(cfg)
    share = []
    for scale in (False, True):
        _, pp = soft(cfgs("reduced")[0], scale=scale)
        with torch.no_grad():
            enc = model.encode(pp, torch.from_numpy(src))
            p = utils.tree_map(lambda w: w[0], pp["groups"]["b0_dec_x"])
            x = L.apply_embed(pp["embed"], torch.from_numpy(tok), cfg)
            q = A.project_q(p["xattn"], L.apply_rmsnorm(p["lnx"], x), cfg,
                            None, use_rope=False)
            k, _ = A.project_kv(p["xattn"], enc, cfg, None, use_rope=False)
            g = cfg.n_heads // cfg.n_kv
            s = torch.einsum("bshd,bthd->bhst", q,
                             k.repeat_interleave(g, 2)) / cfg.hd ** 0.5
        share.append(float(s.softmax(-1).amax(-1).mean()))
    assert share[0] > 0.9 and share[1] < 0.5, share


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_forward(case):
    """The reference's test_decode_matches_forward: the stepped decode
    over a cross cache built from the source (max_len = S_src = 16)
    against the full forward, rel < 1e-4; and within F32 of the
    reference's decode logits."""
    ref_cfg, cfg = cfgs(case)
    rp, pp = soft(ref_cfg)
    tok, src = inputs(cfg)
    model, ref_model = build_model(cfg), ref_build(ref_cfg)
    n = 8
    with torch.no_grad():
        cache = model.init_cache(B, S, "cpu")
        cache["cross"] = model.build_cross_cache(
            pp, model.encode(pp, torch.from_numpy(src)))
        got = []
        for t in range(n):
            lg, cache = model.decode_step(pp, torch.from_numpy(tok[:, t]),
                                          cache, t)
            got.append(lg)
        got = torch.stack(got, 1)
        fwd, _ = model.forward(pp, {"tokens": torch.from_numpy(tok[:, :n]),
                                    "src_embeds": torch.from_numpy(src)})
    rel = float((got - fwd).abs().max() / fwd.abs().max())
    assert rel < 1e-4, rel
    rcache = ref_model.init_cache(B, S)
    rcache["cross"] = ref_model.build_cross_cache(
        rp, ref_model.encode(rp, jnp.asarray(src)))
    step = jax.jit(ref_model.decode_step)
    want = []
    for t in range(n):
        lg, rcache = step(rp, jnp.asarray(tok[:, t]), rcache,
                          jnp.asarray(t, jnp.int32))
        want.append(lg)
    close(got, jnp.stack(want, 1), F32)


def test_decode_step_returns_the_cross_leaves_as_given():
    """A decode step clones the self cache and hands the cross leaves
    back as the same tensors, unwritten (the reference returns them as
    given); the cache passed in is not modified."""
    _, cfg = cfgs("reduced")
    _, pp = soft(cfgs("reduced")[0])
    model = build_model(cfg)
    cache = model.init_cache(B, S, "cpu")
    cache["cross"] = {n: torch.randn(cfg.n_layers, B, S, cfg.n_kv, cfg.hd)
                      for n in ("k", "v")}
    before = utils.tree_map(torch.clone, cache)
    with torch.no_grad():
        _, new = model.decode_step(pp, torch.zeros(B, dtype=torch.int64),
                                   cache, 0)
    for n in ("k", "v"):
        assert new["cross"][n] is cache["cross"][n]
    assert new["groups"]["b0_dec_x"]["k"] is not cache["groups"][
        "b0_dec_x"]["k"]
    assert utils.tree_equal_bits(cache, before)
    assert not torch.equal(new["groups"]["b0_dec_x"]["k"],
                           before["groups"]["b0_dec_x"]["k"])


def test_bf16_loss_and_gradients():
    """The reduced model at bf16 compute against the reference run op by
    op: the loss within 1e-4, each gradient at a cosine of 0.995 and a
    norm within 5%."""
    ref_cfg, cfg = cfgs("reduced", "bfloat16")
    rp, pp = soft(ref_cfg)
    rb, pb = batches(*inputs(cfg, src_len=24))
    with jax.disable_jit():
        (want, _), wg = jax.value_and_grad(ref_build(ref_cfg).loss,
                                           has_aux=True)(rp, rb)
    got, _, gg = api.make_loss_and_grads(build_model(cfg))(pp, pb)
    close(got, want, BF16_LOSS)
    same_grads(gg, wg, {"cos": BF16_COS, "grad": np.inf})
    for a, b in zip(utils.tree_leaves(gg), jax.tree.leaves(wg),
                    strict=True):
        ratio = float(a.double().norm()) / float(
            np.linalg.norm(np.asarray(b, np.float64)))
        assert abs(ratio - 1) <= BF16_NORM, ratio


def test_convert_carries_the_new_leaves():
    """`params_to_port` and `train_state_to_port` take the reference's
    encoder-decoder trees bit for bit: `enc_groups`, `enc_norm` and each
    decoder layer's `lnx` and `xattn` among them, in the reference's
    leaf order."""
    from repro.configs.base import TrainConfig as RefTrainConfig
    from repro.models import api as ref_api
    from repro.optim import build_optimizer as ref_build_optimizer
    ref_cfg, _ = cfgs("reduced")
    model = ref_build(ref_cfg)
    params = model.init(jax.random.PRNGKey(0))
    opt = ref_build_optimizer(RefTrainConfig(), ref_cfg)
    state = ref_api.init_train_state(model, opt, jax.random.PRNGKey(0))
    state = jax.tree.map(np.asarray, state)
    for ref_tree, port_tree in (
            (params, convert.params_to_port(jax.tree.map(np.asarray,
                                                         params), "cpu")),
            (state, convert.train_state_to_port(state, "cpu"))):
        want = jax.tree.leaves_with_path(ref_tree)
        got = utils.tree_leaves(port_tree)
        assert len(want) == len(got)
        for (path, w), g in zip(want, got):
            assert np.asarray(w).tobytes() == convert._np_leaf(g).tobytes()
    dec = params["groups"]["b0_dec_x"]
    assert {"lnx", "xattn"} <= set(dec) and "enc_norm" in params
    assert set(convert.params_to_port(jax.tree.map(np.asarray, params),
                                      "cpu")) == set(params)


@pytest.mark.parametrize("reduced", [False, True])
def test_count_params(reduced):
    cfg = registry.get_config(ARCH, reduced=reduced)
    want = ref_registry.get_config(ARCH, reduced=reduced).param_count()
    assert api.count_params(cfg) == want == cfg.param_count()
    assert api.count_params(cfg, active_only=True) == want
    if not reduced:
        assert want == 2_034_784_256


def test_cache_specs_follow_the_references_rule():
    """The cross leaves' specs: KV heads on `model` where they divide it,
    else the source sequence (the reference's rule), and the self cache's
    as a dense decoder's."""
    from repro.models.transformer import build_model as rb
    from tests import _torch_ref as tr
    for case, mesh_name in (("reduced", "mesh42"), ("encdec", "mesh42"),
                            ("encdec", "mesh81")):
        ref_cfg, cfg = cfgs(case)
        want = rb(ref_cfg).cache_specs(4, 24, tr.jax_mesh(mesh_name))
        got = build_model(cfg).cache_specs(4, 24, tr.zone_mesh(mesh_name))
        flat_w = jax.tree.leaves(want, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        flat_g = utils.tree_leaves(got)
        assert [tuple(w) for w in flat_w] == [tuple(g) for g in flat_g], (
            case, mesh_name)


# -- chip_smoke's es h and et i on the CPU ------------------------------------

def es_inputs():
    """The reduced model on `hybrid_params`' weights (f32 compute), an
    unprotected server on (4, 2) whose cross cache `ed_fill` filled from
    a seeded source of max_len 24 frames, and its greedy tokens:
    (cfg, params, prompt, tokens, source)."""
    from repro_torch import ProtectConfig, ZoneMesh
    from repro_torch.runtime.server import Server
    cfg = dataclasses.replace(registry.get_config(ARCH, reduced=True),
                              compute_dtype="float32")
    params = chip_smoke.hybrid_params(cfg, torch.device("cpu"))
    src = torch.from_numpy(inputs(cfg, src_len=24, seed=5)[1])
    srv = Server(cfg, ProtectConfig(), ZoneMesh((4, 2), ("data", "model")),
                 batch=B, max_len=24, protect_cache=False, device="cpu")
    srv.start(params)
    chip_smoke.ed_fill(srv, chip_smoke.ed_cross(srv.model, srv.params, src))
    prompt = torch.randint(0, cfg.vocab, (B, 6),
                           generator=torch.Generator().manual_seed(1))
    return cfg, params, prompt, srv.generate(prompt, 10), src


def test_es_h_passes_the_port():
    """es h end to end on the reduced model: the served tokens
    teacher-forced through the decode over the filled cross cache,
    against the f32 forward of encoder and decoder, within 2^-4."""
    cfg, params, prompt, toks, src = es_inputs()
    got = chip_smoke.sv_reference(cfg, params, prompt, toks, 24, src=src)
    assert got["positions_over_bound"] == 0 and got["rel_err"] < 1e-5, got


@pytest.mark.parametrize("fault", [{"enc_causal": True}, {"cross": False}])
def test_es_h_catches_a_planted_fault(fault):
    """The plain forward with a causal encoder, or with no cross
    attention: es h fails."""
    cfg, params, prompt, toks, src = es_inputs()
    with pytest.raises(AssertionError, match="h: "):
        chip_smoke.sv_reference(cfg, params, prompt, toks, 24, src=src,
                                plain_kw=fault)


def et_inputs(dtype):
    from repro_torch.data.synthetic import batch_for
    cfg = dataclasses.replace(registry.get_config(ARCH, reduced=True),
                              compute_dtype=dtype)
    params = chip_smoke.hybrid_params(cfg, torch.device("cpu"))
    batch = batch_for(cfg, 32, 2, 0).device_batch(0, "cpu")
    return cfg, params, batch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_et_i_passes_the_port(dtype):
    got = chip_smoke.tr_grad_check(*et_inputs(dtype))
    assert got["ok"], got
    if dtype == "float32":
        assert got["loss_rel_err"] < 1e-6 and got["min_grad_cos"] > 1 - 1e-9


@pytest.mark.parametrize("fault", [{"enc_causal": True}, {"cross": False}])
def test_et_i_catches_a_planted_fault(fault):
    got = chip_smoke.tr_grad_check(*et_inputs("float32"), **fault)
    assert not got["ok"], got
