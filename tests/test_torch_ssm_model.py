"""The ssm family's whole model (xlstm-1.3b's `reduced()`: one group of
(mlstm, mlstm, mlstm, slstm), d_model 64, 4 heads) against the
reference's: forward, loss, gradients, the teacher-forced decode, the
compute-dtype cast, parameter and cache specs, the published count; the
tests/test_models.py ssm_xlstm family's decode-against-forward property.
The cells and blocks are in tests/test_torch_xlstm.py, whose stated
tolerances these tests use:

  * f32: the loss within 1e-6, forward logits, gradients and decode
    logits within MODEL_F32 = 1e-4 of the largest magnitude (the
    packages' exp, log-sigmoid and cumulative sums differ in the last f32
    bits, and four layers carry them; measured 1.2e-5 on a gradient).
  * bf16, the reference op by op (`jax.disable_jit`, its batched bf16
    products through `_torch_ref.f32_dots`): the loss within 1e-4, each
    decode step from the reference's cache within STEP_RTOL = 2^-5 of the
    largest logit and its state within 2^-6 (the conv history within
    2^-7), gradients at a cosine of 0.999 a leaf and norms within 5%.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.base import ModelConfig as RefModelConfig
from repro.models import api as ref_api
from repro.models import xlstm as ref_xlstm
from repro.models.transformer import build_model as ref_build
from repro_torch import convert, utils
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import batch_for
from repro_torch.models import api
from repro_torch.models import params as prm
from repro_torch.models.transformer import build_model
from tests import _torch_ref as tr
from tests.test_torch_hybrid import (BF16_RTOL, _spec_pairs, both, close,
                                     ref_params, same_grads)
from tests.test_torch_xlstm import ARCH, STATE_BF16_RTOL, cfgs
from tests._torch_ref import compile_cache, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("compile_cache", "one_thread")

MODEL_F32 = 1e-4
STEP_RTOL = 2 ** -5
MODEL_BF16_COS = 0.999
MODEL_BF16_NORM = 0.05


@pytest.fixture(autouse=True)
def _f32_dots(monkeypatch):
    tr.f32_dots(monkeypatch, ref_xlstm)


def tokens(cfg, B=2, S=40, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_the_reference(dtype):
    ref_cfg, cfg = cfgs(dtype)
    jp, pp = both(ref_params(ref_cfg))
    tok = tokens(cfg)
    loss = jax.value_and_grad(ref_build(ref_cfg).loss, has_aux=True)
    if dtype == "float32":
        loss = jax.jit(loss)
    with jax.disable_jit(dtype == "bfloat16"):
        (want, wm), wg = loss(jp, {"tokens": jnp.asarray(tok)})
    got, gm, gg = api.make_loss_and_grads(build_model(cfg))(
        pp, {"tokens": torch.from_numpy(tok)})
    tol = 1e-6 if dtype == "float32" else 1e-4
    close(got, want, tol)
    for k in ("ce", "z_loss"):
        close(gm[k], wm[k], tol)
    assert float(gm["aux"]) == float(wm["aux"]) == 0.0
    if dtype == "float32":
        same_grads(gg, wg, {"grad": MODEL_F32, "cos": 1 - 1e-9})
        return
    same_grads(gg, wg, {"cos": MODEL_BF16_COS, "grad": np.inf})
    for a, b in zip(utils.tree_leaves(gg), jax.tree.leaves(wg), strict=True):
        ratio = float(a.double().norm()) / float(
            np.linalg.norm(np.asarray(b, np.float64)))
        assert abs(ratio - 1) <= MODEL_BF16_NORM, ratio


def test_forward_logits_match_the_reference():
    ref_cfg, cfg = cfgs("float32")
    jp, pp = both(ref_params(ref_cfg))
    tok = tokens(cfg, S=24, seed=1)
    want, waux = jax.jit(ref_build(ref_cfg).forward)(
        jp, {"tokens": jnp.asarray(tok)})
    with torch.no_grad():
        got, aux = build_model(cfg).forward(pp, {"tokens":
                                                 torch.from_numpy(tok)})
    close(got, want, MODEL_F32)
    assert float(aux) == float(waux) == 0.0


def test_decode_step_teacher_forced_f32():
    """Logits step by step over 24 positions, both packages fed the
    reference's greedy tokens, each carrying its own cache (the given one
    left as it was); the states agree at the end."""
    ref_cfg, cfg = cfgs("float32")
    jp, pp = both(ref_params(ref_cfg))
    ref_m, port_m = ref_build(ref_cfg), build_model(cfg)
    step = jax.jit(ref_m.decode_step)
    B, T = 3, 24
    jc = ref_m.init_cache(B, T)
    pc = port_m.init_cache(B, T, device="cpu")
    tok = np.random.default_rng(17).integers(0, cfg.vocab, B).astype(
        np.int32)
    for pos in range(T):
        want, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(pos, jnp.int32))
        before = convert._np_leaf(pc["groups"]["b0_mlstm"]["C"]).copy()
        got, new_pc = port_m.decode_step(pp, torch.from_numpy(tok), pc, pos)
        assert convert._np_leaf(pc["groups"]["b0_mlstm"]["C"]).tobytes() == \
            before.tobytes()
        close(got, want, MODEL_F32)
        pc = new_pc
        tok = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
    for want, got in zip(jax.tree.leaves(jc), utils.tree_leaves(pc),
                         strict=True):
        close(got, want, MODEL_F32)


def test_decode_step_bf16_from_the_references_cache():
    """At bf16 each step starts from the reference's cache (op by op):
    logits within STEP_RTOL, the new state within STATE_BF16_RTOL (the
    conv history within BF16_RTOL), over 12 positions."""
    ref_cfg, cfg = cfgs("bfloat16")
    jp, pp = both(ref_params(ref_cfg))
    ref_m, port_m = ref_build(ref_cfg), build_model(cfg)
    B, T = 3, 12
    tok = np.random.default_rng(18).integers(0, cfg.vocab, B).astype(
        np.int32)
    with jax.disable_jit():
        jc = ref_m.init_cache(B, T)
        for pos in range(T):
            pc = convert.params_to_port(jax.tree.map(np.asarray, jc), "cpu")
            want, jc = ref_m.decode_step(jp, jnp.asarray(tok), jc,
                                         jnp.asarray(pos, jnp.int32))
            got, pc = port_m.decode_step(pp, torch.from_numpy(tok), pc, pos)
            close(got, want, STEP_RTOL)
            flat = jax.tree_util.tree_leaves_with_path(jc)
            for (path, w), g in zip(flat, utils.tree_leaves(pc),
                                    strict=True):
                name = jax.tree_util.keystr(path)
                close(g, w, BF16_RTOL if "'conv'" in name
                      else STATE_BF16_RTOL)
            tok = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)


def test_compute_params_keep_what_the_reference_reads_in_f32():
    """Server.start's cast: the mLSTM's gate bias and output norm, the
    sLSTM's recurrent weights, bias and output norm, and the norms'
    scales stay f32; every other leaf is cast once to bf16."""
    ref_cfg, cfg = cfgs("bfloat16")
    pp = convert.params_to_port(ref_params(ref_cfg), "cpu")
    cp = build_model(cfg).compute_params(pp)
    g = cp["groups"]
    for n in ("b_if", "outnorm"):
        assert g["b0_mlstm"]["cell"][n].dtype == torch.float32
    for n in ("w_up", "w_down", "conv_w", "conv_b", "wq", "wk", "wv",
              "w_if"):
        assert g["b0_mlstm"]["cell"][n].dtype == torch.bfloat16
    for n in ("r_h", "bias", "outnorm"):
        assert g["b3_slstm"]["cell"][n].dtype == torch.float32
    for n in ("w_in", "w_out"):
        assert g["b3_slstm"]["cell"][n].dtype == torch.bfloat16
    assert g["b3_slstm"]["cell"]["norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("mesh_name", ["mesh42", "mesh81"])
@pytest.mark.parametrize("reduced", [False, True])
def test_param_and_cache_specs_match_the_reference(reduced, mesh_name):
    """Every parameter and state leaf: the same tree, shapes, dtypes and
    partition specs (at full width 6 groups of 8 blocks, no tail)."""
    mesh, zmesh = tr.jax_mesh(mesh_name), tr.zone_mesh(mesh_name)
    ref_m = ref_build(ref_registry.get_config(ARCH, reduced=reduced), mesh)
    port_m = build_model(registry.get_config(ARCH, reduced=reduced), zmesh)
    assert port_m.tail == ref_m.tail == ()
    ref_abs = ref_m.abstract_params()
    port_abs = prm.abstract_params(port_m.param_defs())
    for want, got in zip(jax.tree.leaves(ref_abs),
                         utils.tree_leaves(port_abs), strict=True):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype) == f"torch.{want.dtype}"
    for want, got in _spec_pairs(ref_m.param_specs(mesh),
                                 port_m.param_specs(zmesh)):
        assert tuple(got) == tuple(want)
    ref_cache = jax.eval_shape(lambda: ref_m.init_cache(4, 2048))
    port_cache = port_m.init_cache(4, 2048, device="meta")
    for want, got in zip(jax.tree.leaves(ref_cache),
                         utils.tree_leaves(port_cache), strict=True):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype) == f"torch.{want.dtype}"
    for want, got in _spec_pairs(ref_m.cache_specs(4, 2048, mesh),
                                 port_m.cache_specs(4, 2048, zmesh)):
        assert tuple(got) == tuple(want)


def test_count_params_and_cache_bytes():
    """The published config: 1,945,057,616 parameters, as the
    reference's (all active), and a 706,560,672 B state a sequence."""
    ref = ref_registry.get_config(ARCH)
    port = registry.get_config(ARCH)
    n = 1_945_057_616
    assert api.count_params(port) == ref_api.count_params(ref) == n
    assert api.count_params(port, active_only=True) == n
    assert port.param_count() == port.active_param_count() == n
    cache = build_model(port).init_cache(1, 2048, device="meta")
    assert sum(x.numel() * x.element_size()
               for x in utils.tree_leaves(cache)) == 706_560_672


T_XL = dict(name="t_xl", family="ssm",
            block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
            subquadratic=True, n_layers=4, d_model=64, n_heads=4, n_kv=4,
            d_ff=0, vocab=256, param_dtype="float32",
            compute_dtype="float32")


def test_decode_matches_forward():
    """tests/test_models.py's ssm_xlstm case on the port: greedy decode
    logits at position t equal the forward's at t (rel 1e-4), with the
    reference's parameters."""
    cfg = ModelConfig(**T_XL)
    model = build_model(cfg)
    params = convert.params_to_port(jax.tree.map(
        np.asarray, ref_build(RefModelConfig(**T_XL)).init(
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


# -- chip_smoke's xs h / xt i checks on the CPU ----------------------------------

def test_plain_xlstm_blocks_match_the_port():
    """chip_smoke's f32 mLSTM (stepped a position at a time, and in
    chunks of 7 and 64: a chunk cut mid-sequence, and one past its end)
    and sLSTM, written apart from the port, against the port's blocks on
    the same weights: within MODEL_F32."""
    import chip_smoke
    _, cfg = cfgs("float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(1), "cpu")
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    from repro_torch.models import xlstm
    with torch.no_grad():
        for t, p in chip_smoke.plain_blocks(cfg, params):
            if t == "slstm":
                close(chip_smoke.plain_slstm(p["cell"], x),
                      xlstm.slstm_apply_train(p["cell"], x, cfg), MODEL_F32)
                continue
            want = xlstm.mlstm_apply_train(p["cell"], x, cfg)
            for chunk in (None, 7, 64):
                close(chip_smoke.plain_mlstm(p["cell"], x, chunk), want,
                      MODEL_F32)


def xt_check_inputs(dtype):
    """The reduced model at `dtype` with chip_smoke's conditioned weights
    (`soft_xlstm`), a 48-token batch."""
    import chip_smoke
    cfg = dataclasses.replace(registry.get_config(ARCH, reduced=True),
                              compute_dtype=dtype)
    params = chip_smoke.xlstm_params(cfg, torch.device("cpu"))
    batch = batch_for(cfg, 48, 2, 0).device_batch(0, "cpu")
    return cfg, params, batch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xt_check_passes_the_port(dtype):
    """xt i's check (the port's step against `chip_smoke.tr_plain_loss`,
    the plain mLSTM in chunks of 16 where the port's are one of 48) on the
    reduced model with xt's conditioned weights: at f32 far inside its
    bounds, at bf16 inside them."""
    import chip_smoke
    got = chip_smoke.tr_grad_check(*xt_check_inputs(dtype),
                                   plain_kw={"mlstm_chunk": 16})
    assert got["ok"], got
    if dtype == "float32":
        assert got["loss_rel_err"] <= chip_smoke.TR_LOSS_RTOL / 100
        assert 1 - got["min_grad_cos"] <= (1 - chip_smoke.TR_GRAD_COS) / 100


def test_xt_check_catches_a_wrong_forget_gate():
    """The plain step is independent: with the port's sLSTM forget gate
    read from the output gate's pre-activation, the check fails."""
    import chip_smoke
    from repro_torch.models import xlstm
    real = xlstm._slstm_cell

    def wrong(p, gx, state):
        return real(p, torch.stack([gx[:, 0], gx[:, 1], gx[:, 3], gx[:, 3]],
                                   1), state)
    cfg, params, batch = xt_check_inputs("float32")
    xlstm._slstm_cell = wrong
    try:
        got = chip_smoke.tr_grad_check(cfg, params, batch)
    finally:
        xlstm._slstm_cell = real
    assert not got["ok"], got


def test_xs_h_passes_the_port():
    """xs h end to end on the reduced bf16 model with xs's conditioned
    weights: an unprotected server's greedy tokens, teacher-forced
    through the decode against the stepped f32 forward: its argmax the
    served tokens, within 2^-4."""
    import chip_smoke
    from repro_torch import ProtectConfig, ZoneMesh
    from repro_torch.runtime.server import Server
    cfg, params, _ = xt_check_inputs("bfloat16")
    srv = Server(cfg, ProtectConfig(), ZoneMesh((4, 2), ("data", "model")),
                 batch=4, max_len=24, protect_cache=False, device="cpu")
    srv.start(params)
    prompt = torch.randint(0, cfg.vocab, (4, 6),
                           generator=torch.Generator().manual_seed(1))
    toks = srv.generate(prompt, 10)
    got = chip_smoke.sv_reference(cfg, params, prompt, toks, 24)
    assert got["positions_over_bound"] == 0 and got["argmax_agree"] > 0.9


@pytest.mark.parametrize("soft", [False, True], ids=["init", "soft_xlstm"])
def test_the_inits_xlstm_stack_is_chaotic_in_bf16(soft):
    """At the reference's init (token embeddings of std 0.02 under block
    outputs of std ~0.6, each feeding the next with a gain above 1) a bf16
    forward of 8 mLSTM blocks at d_model 256 sits over 2^-4 of the
    largest logit from the f32 one (measured 0.36; this file's bf16 tests
    hold the port to the reference's bf16 instead); with
    `chip_smoke.soft_xlstm`'s conditioning, within 2^-5 (ROADMAP queue
    C)."""
    import chip_smoke
    cfg = dataclasses.replace(registry.get_config(ARCH), d_model=256,
                              n_layers=8, vocab=512,
                              block_pattern=("mlstm",) * 8,
                              compute_dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    if soft:
        chip_smoke.soft_xlstm(params, cfg.n_layers)
    tok = torch.from_numpy(tokens(cfg, S=24))
    with torch.no_grad():
        want, _ = build_model(cfg).forward(params, {"tokens": tok})
        got, _ = build_model(dataclasses.replace(
            cfg, compute_dtype="bfloat16")).forward(params, {"tokens": tok})
    rel = float((got - want).abs().max() / want.abs().max())
    assert (rel < 2 ** -5) if soft else (rel > 2 ** -4), rel
