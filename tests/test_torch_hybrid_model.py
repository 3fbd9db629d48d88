"""The hybrid family's whole model (recurrentgemma-2b's `reduced()`: one
group of (rglru, rglru, attn) and a tail of two rglru blocks, window 16)
against the reference's: loss and gradients, the teacher-forced decode
past the window, the compute-dtype cast; and chip_smoke's rg h / rt i
checks on the CPU.  The modules and blocks are in
tests/test_torch_hybrid.py, whose helpers and stated tolerances these
tests use:

  * f32: the model's loss within 1e-6; its gradients and its decode
    within 1e-4 (MODEL_F32): the sigmoid / exp / softplus of each package
    differ in the last f32 bits, and the recurrence and the layers above
    it carry them (measured 2.8e-5 on a gradient, 2.3e-5 on a decode
    logit).
  * bf16: the loss within 1e-4; each decode step from the reference's own
    cache, the reference run op by op (`jax.disable_jit`) so no step
    inherits another's rounding, within STEP_RTOL = 2^-5 of the largest
    logit (measured 0.021: the reduced model's residual stream runs to
    ~40 against logits below 1); gradients, the reference also run op by
    op (jitted, XLA keeps its layer scan's bf16 intermediates in f32 and
    the recurrence amplifies each one-unit difference: 0.959), at a
    cosine of MODEL_BF16_COS = 0.995 a leaf and a norm within
    MODEL_BF16_NORM = 5% of the reference's (measured 0.9976 and
    0.984-1.008).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import build_model as ref_build
from repro_torch import convert, utils
from repro_torch.configs import registry
from repro_torch.data.synthetic import batch_for
from repro_torch.models import api
from repro_torch.models import params as prm
from repro_torch.models.transformer import build_model
from tests.test_torch_hybrid import (ARCH, BF16_RTOL, DTYPES, F32_RTOL, GRAD,
                                     both, cfgs, close, ref_params,
                                     same_grads)

import chip_smoke
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

STEP_RTOL = 2 ** -5
MODEL_F32 = 1e-4
MODEL_BF16_COS = 0.995
MODEL_BF16_NORM = 0.05


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_gradients_match_the_reference(dtype):
    ref_cfg, cfg = cfgs(dtype)
    params = ref_build(ref_cfg).init(jax.random.PRNGKey(0))
    pp = convert.params_to_port(jax.tree.map(np.asarray, params), "cpu")
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (2, 40)).astype(
        np.int32)
    with jax.disable_jit(dtype == "bfloat16"):
        (want, wm), wg = jax.value_and_grad(ref_build(ref_cfg).loss,
                                            has_aux=True)(
            params, {"tokens": jnp.asarray(tok)})
    got, gm, gg = api.make_loss_and_grads(build_model(cfg))(
        pp, {"tokens": torch.from_numpy(tok)})
    tol = GRAD[dtype]
    close(got, want, tol["loss"])
    for k in ("ce", "z_loss"):
        close(gm[k], wm[k], tol["loss"])
    assert float(gm["aux"]) == float(wm["aux"]) == 0.0
    if dtype == "float32":
        same_grads(gg, wg, dict(tol, grad=MODEL_F32))
    else:
        same_grads(gg, wg, {"cos": MODEL_BF16_COS, "grad": np.inf})
        for a, b in zip(utils.tree_leaves(gg), jax.tree.leaves(wg),
                        strict=True):
            ratio = float(a.double().norm()) / float(
                np.linalg.norm(np.asarray(b, np.float64)))
            assert abs(ratio - 1) <= MODEL_BF16_NORM, ratio


def test_decode_step_teacher_forced_f32():
    """Logits step by step over 40 positions (the window-16 ring wraps
    twice), both packages fed the reference's greedy tokens, each carrying
    its own cache; the caches agree at the end, the ring's slot positions
    bit for bit."""
    ref_cfg, cfg = cfgs("float32")
    jp, pp = both(ref_params(ref_cfg))
    ref_m, port_m = ref_build(ref_cfg), build_model(cfg)
    step = jax.jit(ref_m.decode_step)
    B, T = 3, 24
    jc = ref_m.init_cache(B, T)
    pc = port_m.init_cache(B, T, device="cpu")
    tok = np.random.default_rng(17).integers(0, cfg.vocab, B).astype(
        np.int32)
    for pos in range(40):
        want, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(pos, jnp.int32))
        before = convert._np_leaf(pc["tail1_rglru"]["h"]).copy()
        got, new_pc = port_m.decode_step(pp, torch.from_numpy(tok), pc, pos)
        # the given cache, the tail's included, is left as it was
        assert convert._np_leaf(pc["tail1_rglru"]["h"]).tobytes() == \
            before.tobytes()
        close(got, want, MODEL_F32)
        pc = new_pc
        tok = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
    for want, got in zip(jax.tree.leaves(jc), utils.tree_leaves(pc),
                         strict=True):
        close(got, want, MODEL_F32)
    assert convert._np_leaf(pc["groups"]["b2_attn"]["pos"]).tobytes() == \
        np.asarray(jc["groups"]["b2_attn"]["pos"]).tobytes()


def test_decode_step_bf16_from_the_references_cache():
    """At bf16 each step starts from the reference's cache (op by op,
    `jax.disable_jit`): logits within STEP_RTOL, the new cache within
    BF16_RTOL (the state h within F32_RTOL), to position 24 (the ring
    of 16 wrapped)."""
    ref_cfg, cfg = cfgs("bfloat16")
    np_params = ref_params(ref_cfg)
    jp, pp = both(np_params)
    ref_m, port_m = ref_build(ref_cfg), build_model(cfg)
    B, T = 3, 24
    tok = np.random.default_rng(18).integers(0, cfg.vocab, B).astype(
        np.int32)
    with jax.disable_jit():
        jc = ref_m.init_cache(B, T)
        for pos in range(24):
            pc = convert.params_to_port(jax.tree.map(np.asarray, jc), "cpu")
            want, jc = ref_m.decode_step(jp, jnp.asarray(tok), jc,
                                         jnp.asarray(pos, jnp.int32))
            got, pc = port_m.decode_step(pp, torch.from_numpy(tok), pc, pos)
            close(got, want, STEP_RTOL)
            flat = jax.tree_util.tree_leaves_with_path(jc)
            for (path, w), g in zip(flat, utils.tree_leaves(pc),
                                    strict=True):
                name = jax.tree_util.keystr(path)
                close(g, w, F32_RTOL if "'h'" in name else BF16_RTOL)
            tok = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)


def test_compute_params_keep_what_the_reference_reads_in_f32():
    """Server.start's cast: the RG-LRU's gate weights and decay stay f32
    (the reference reads them from the f32 parameters), the norms' scales
    too; every other leaf is cast once to bf16."""
    ref_cfg, cfg = cfgs("bfloat16")
    pp = convert.params_to_port(ref_params(ref_cfg), "cpu")
    cp = build_model(cfg).compute_params(pp)
    for tree in (cp["groups"]["b0_rglru"], cp["tail0_rglru"]):
        for n in ("wa", "ba", "wx", "bx", "lam"):
            assert tree["rec"][n].dtype == torch.float32
        for n in ("wg", "wr", "wo", "conv_w", "conv_b"):
            assert tree["rec"][n].dtype == torch.bfloat16
        assert tree["ln1"]["scale"].dtype == torch.float32
    assert cp["groups"]["b2_attn"]["attn"]["wq"].dtype == torch.bfloat16


# -- chip_smoke's rg h and rt i checks on the CPU --------------------------------

def test_rg_f32_forward_matches_the_reference():
    """rg h's f32 forward (`chip_smoke.sv_plain_logits`: the RG-LRU a loop
    over time, the conv a grouped conv1d, windowed attention by sdpa with
    a mask) against the reference's decode logits, teacher-forced on its
    greedy tokens past the window (16), within MODEL_F32."""
    ref_cfg, cfg = cfgs("float32")
    jp, pp = both(ref_params(ref_cfg))
    ref_m = ref_build(ref_cfg)
    step = jax.jit(ref_m.decode_step)
    B, T, S = 3, 24, 24
    jc = ref_m.init_cache(B, T)
    tok = np.random.default_rng(19).integers(0, cfg.vocab, B).astype(
        np.int32)
    seq, want = [], []
    for pos in range(S):
        seq.append(tok)
        logits, jc = step(jp, jnp.asarray(tok), jc,
                          jnp.asarray(pos, jnp.int32))
        want.append(np.asarray(logits))
        tok = np.asarray(jnp.argmax(logits, axis=-1)).astype(np.int32)
    got = chip_smoke.sv_plain_logits(cfg, pp,
                                     torch.from_numpy(np.stack(seq, 1)))
    close(got, np.stack(want, 1), MODEL_F32)


def rt_check_inputs(dtype="float32"):
    cfg = dataclasses.replace(registry.get_config(ARCH, reduced=True),
                              n_layers=3, compute_dtype=dtype)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    batch = batch_for(cfg, 48, 2, 0).device_batch(0, "cpu")
    return cfg, params, batch


def test_rt_check_passes_the_port_at_f32():
    """rt i's held check (the port's step at f32 compute against
    `chip_smoke.tr_plain_loss`) on one group (rglru, rglru, attn), the
    sequence (48) three windows long: far inside its bounds."""
    got = chip_smoke.tr_grad_check(*rt_check_inputs())
    assert got["ok"], got
    assert got["loss_rel_err"] <= chip_smoke.TR_LOSS_RTOL / 100
    assert 1 - got["min_grad_cos"] <= (1 - chip_smoke.TR_GRAD_COS) / 100


@pytest.mark.parametrize("fault", [{"causal": False}, {"theta": 1e6}],
                         ids=["no_causal_mask", "theta_1e6"])
def test_rt_check_catches_faults(fault):
    got = chip_smoke.tr_grad_check(*rt_check_inputs(), **fault)
    assert not got["ok"], got


def test_rt_plain_step_without_the_window_is_caught():
    """The plain forward's window mask matters: with the window widened
    past the sequence, the check fails."""
    cfg, params, batch = rt_check_inputs()
    wide = dataclasses.replace(cfg, window=1024)
    loss, _, grads = api.make_loss_and_grads(build_model(cfg))(params, batch)
    plain = chip_smoke.tr_plain_loss(wide, params, batch["tokens"])
    assert abs(float(plain) - float(loss)) > 1e-6 * abs(float(loss))


def test_the_inits_heads_fan_in_makes_attention_one_hot():
    """The reference's init draws a (d, heads, head_dim) projection with
    std 1/sqrt(heads) (`shape[-2]` as the fan-in), and the port's the
    same; without qk-norm, recurrentgemma-2b's first attention scores at
    init then have a std of several hundred (ROADMAP queue C).
    `chip_smoke.soft_attention` scales wq, wk and wv to a d_model fan-in,
    where q and the scores have a std near 1, and the hybrid's checks
    serve and train such weights."""
    from repro.models import params as ref_prm
    cfg = registry.get_config(ARCH)
    d = prm.ParamDef((cfg.d_model, cfg.n_heads, cfg.hd), "float32",
                     ("embed", "heads", "head_dim"))
    ref_d = ref_prm.ParamDef(d.shape, "float32", d.logical)
    gen = torch.Generator().manual_seed(0)
    wq = prm._init_one(d, gen, "cpu")
    wk = prm._init_one(dataclasses.replace(d, shape=(cfg.d_model, cfg.n_kv,
                                                     cfg.hd)), gen, "cpu")
    ref_wq = np.asarray(ref_prm._init_one(ref_d, jax.random.PRNGKey(0)))
    for w in (wq.numpy(), ref_wq):
        assert abs(float(w.std()) - cfg.n_heads ** -0.5) < 2e-3
    h = torch.randn(64, cfg.d_model, generator=gen)
    h = h / h.pow(2).mean(-1, keepdim=True).sqrt()     # an rmsnorm's output
    q = torch.einsum("sd,dnh->snh", h, wq)
    k = torch.einsum("sd,dnh->snh", h, wk)
    scores = torch.einsum("snh,tkh->snt", q, k) / cfg.hd ** 0.5
    assert float(q.std()) > 10 and float(scores.std()) > 300
    wv = prm._init_one(dataclasses.replace(d, shape=(cfg.d_model, cfg.n_kv,
                                                     cfg.hd)), gen, "cpu")
    soft = chip_smoke.soft_attention(
        {"groups": {"b2_attn": {"attn": {"wq": wq[None], "wk": wk[None],
                                         "wv": wv[None]}}}})
    wq, wk, wv = (soft["groups"]["b2_attn"]["attn"][w][0]
                  for w in ("wq", "wk", "wv"))
    for w in (wq, wk, wv):
        assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1) < 0.01
    q = torch.einsum("sd,dnh->snh", h, wq)
    k = torch.einsum("sd,dnh->snh", h, wk)
    scores = torch.einsum("snh,tkh->snt", q, k) / cfg.hd ** 0.5
    assert 0.9 < float(q.std()) < 1.1 and float(scores.std()) < 1.5


def test_rg_reference_passes_the_port():
    """rg h end to end on the reduced bf16 model with chip_smoke's
    weights, its own greedy tokens teacher-forced: the bf16 decode's
    argmax gives the tokens and its logits are within SV_LOGIT_RTOL of
    the f32 forward; tokens it did not make fail it."""
    _, cfg = cfgs("bfloat16")
    model = build_model(cfg)
    params = chip_smoke.hybrid_params(cfg, "cpu")
    cp = model.compute_params(params)
    B, P, N = 3, 8, 12                  # to position 18: the ring wrapped
    prompt = torch.from_numpy(np.random.default_rng(21).integers(
        0, cfg.vocab, (B, P)))
    cache, out, tok = model.init_cache(B, cfg.window, "cpu"), [], None
    for t in range(P + N - 1):
        logits, cache = model.decode_step(
            cp, prompt[:, t] if t < P else tok, cache, t)
        tok = torch.argmax(logits, dim=-1)
        if t >= P - 1:
            out.append(tok)
    toks = torch.stack(out, 1).numpy().astype(np.int32)
    got = chip_smoke.rg_reference(cfg, params, prompt, toks)
    assert got["positions_over_bound"] == 0
    assert got["compute_dtype"] == "bfloat16"
    wrong = toks.copy()
    wrong[0, -1] = (wrong[0, -1] + 1) % cfg.vocab
    with pytest.raises(AssertionError, match="argmax"):
        chip_smoke.rg_reference(cfg, params, prompt, wrong)
