"""The port's vlm family (chameleon-34b: dense blocks with qk-norm behind a
prefix of multimodal stub embeddings, `mm_embeds`) against the
reference's, on the same numpy inputs at reduced sizes (`reduced()`: 2
layers, d_model 64, GQA 4 / 2, 4 stub positions, untied embeddings).

Tolerances as tests/test_torch_train_model.py and test_torch_models.py
state them for the dense family, whose blocks these are: loss, logits
and hidden state within 1e-6 / 1e-5 at f32 and 1e-4 / 2^-6 at bf16 of the
reference's largest magnitude; gradients within 2e-5 and a cosine of
1 - 1e-9 a leaf at f32, 2^-5 and 0.999 at bf16; decode logits within 1e-5
at f32 and 2^-6 at bf16.  Specs, batches and counts are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.base import ModelConfig as RefModelConfig
from repro.data.synthetic import batch_for as ref_batch_for
from repro.models import api as ref_api
from repro.models.transformer import build_model as ref_build
from repro_torch import convert, utils
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import batch_for
from repro_torch.models import api
from repro_torch.models.transformer import Model, build_model
from tests import _torch_ref as tr

import chip_smoke
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = "chameleon-34b"
DTYPES = ("float32", "bfloat16")
RTOL = {"float32": {"loss": 1e-6, "grad": 2e-5, "cos": 1 - 1e-9,
                    "logit": 1e-5},
        "bfloat16": {"loss": 1e-4, "grad": 2 ** -5, "cos": 0.999,
                     "logit": 2 ** -6}}
S, B = 24, 3


def cfgs(dtype):
    ref = dataclasses.replace(ref_registry.get_config(ARCH, reduced=True),
                              compute_dtype=dtype)
    port = dataclasses.replace(registry.get_config(ARCH, reduced=True),
                               compute_dtype=dtype)
    return ref, port


def close(got, want, tol):
    want = np.asarray(jnp.asarray(want, jnp.float32)).astype(np.float64)
    got = got.detach().float().numpy().astype(np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), err


def setup(dtype, seed=0):
    """(reference config, port config, reference params, port params,
    reference batch, port batch): a synthetic batch of S positions, the
    first `mm_positions` of them stub embeddings."""
    ref_cfg, cfg = cfgs(dtype)
    params = ref_build(ref_cfg).init(jax.random.PRNGKey(seed))
    pp = convert.params_to_port(jax.tree.map(np.asarray, params), "cpu")
    nb = batch_for(cfg, S, B, seed).batch_at(seed)
    assert nb["mm_embeds"].shape == (B, cfg.mm_positions, cfg.d_model)
    assert nb["tokens"].shape == (B, S - cfg.mm_positions)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    return ref_cfg, cfg, params, pp, jb, tb


def test_builds_a_dense_model_with_the_stub_prefix():
    for reduced in (False, True):
        m = build_model(registry.get_config(ARCH, reduced=reduced))
        assert type(m) is Model and m.pattern == ("dense",) and m.tail == ()
        assert m.cfg.mm_positions in (4, 256)


@pytest.mark.parametrize("mesh_name", ["mesh42", "mesh81"])
@pytest.mark.parametrize("reduced", [False, True])
def test_specs_match_the_reference(reduced, mesh_name):
    mesh, zmesh = tr.jax_mesh(mesh_name), tr.zone_mesh(mesh_name)
    ref_m = ref_build(ref_registry.get_config(ARCH, reduced=reduced), mesh)
    port_m = build_model(registry.get_config(ARCH, reduced=reduced), zmesh)
    pairs = [(ref_m.param_specs(mesh), port_m.param_specs(zmesh)),
             (ref_m.cache_specs(16, 2048, mesh),
              port_m.cache_specs(16, 2048, zmesh))]
    for ref_tree, port_tree in pairs:
        ref_leaves = jax.tree.leaves(ref_tree, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        for want, got in zip(ref_leaves, utils.tree_leaves(port_tree),
                             strict=True):
            assert tuple(got) == tuple(want)


@pytest.mark.parametrize("global_batch", [2, 8, 1 << 30])
@pytest.mark.parametrize("mesh_name", ["mesh42", "mesh81"])
def test_batch_specs_match_the_reference(mesh_name, global_batch):
    """The batch's specs, `mm_embeds` included, with the divisibility
    fallback (a global batch of 2 on 4 or 8 data ranks)."""
    mesh, zmesh = tr.jax_mesh(mesh_name), tr.zone_mesh(mesh_name)
    for arch in (ARCH, "recurrentgemma-2b"):
        want = ref_api.batch_specs(ref_registry.get_config(arch), mesh,
                                   global_batch)
        got = api.batch_specs(registry.get_config(arch), zmesh, global_batch)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k]) == tuple(want[k]), (arch, k)


def test_synthetic_batches_carry_the_references_stub_embeds():
    ref_cfg, cfg = cfgs("float32")
    for cursor in (0, 5):
        want = ref_batch_for(ref_cfg, S, B, 3).batch_at(cursor)
        got = batch_for(cfg, S, B, 3).batch_at(cursor)
        assert sorted(got) == sorted(want) == ["mm_embeds", "tokens"]
        for k in want:
            assert got[k].tobytes() == np.asarray(want[k]).tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_gradients_match_the_reference(dtype):
    ref_cfg, cfg, params, pp, jb, tb = setup(dtype)
    (want, wm), wg = jax.value_and_grad(ref_build(ref_cfg).loss,
                                        has_aux=True)(params, jb)
    got, gm, gg = api.make_loss_and_grads(build_model(cfg))(pp, tb)
    tol = RTOL[dtype]
    close(got, want, tol["loss"])
    for k in ("ce", "z_loss"):
        close(gm[k], wm[k], tol["loss"])
    leaves = list(zip(utils.tree_leaves(gg), jax.tree.leaves(wg),
                      strict=True))
    for a, b in leaves:
        x = a.double().reshape(-1).numpy()
        y = np.asarray(b, np.float64).reshape(-1)
        assert x @ y / np.linalg.norm(x) / np.linalg.norm(y) >= tol["cos"]
        close(a, b, tol["grad"])
    # the stub embeddings reach the loss: a change to them moves it
    tb2 = dict(tb, mm_embeds=tb["mm_embeds"] * 3)
    other, _, _ = api.make_loss_and_grads(build_model(cfg))(pp, tb2)
    assert float(other) != float(got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_hidden_and_prefill_match_the_reference(dtype):
    ref_cfg, cfg, params, pp, jb, tb = setup(dtype, seed=1)
    ref_model, model = ref_build(ref_cfg), build_model(cfg)
    tol = RTOL[dtype]["logit"]
    with torch.no_grad():
        logits = api.make_forward(model)(pp, tb)
        assert logits.shape == (B, S, cfg.vocab)
        close(logits, ref_api.make_forward(ref_model)(params, jb), tol)
        close(api.make_prefill(model)(pp, tb),
              ref_api.make_prefill(ref_model)(params, jb), tol)
        x, _ = model.hidden(pp, tb)
    close(x, ref_model.hidden(params, jb)[0], tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_teacher_forced(dtype):
    """The served decode (tokens only, as the reference's decode_step):
    10 positions, both packages fed the reference's greedy tokens."""
    ref_cfg, cfg = cfgs(dtype)
    params = ref_build(ref_cfg).init(jax.random.PRNGKey(2))
    pp = convert.params_to_port(jax.tree.map(np.asarray, params), "cpu")
    ref_m, port_m = ref_build(ref_cfg), build_model(cfg)
    step = jax.jit(ref_m.decode_step)
    jc = ref_m.init_cache(B, 16)
    pc = port_m.init_cache(B, 16, device="cpu")
    tok = np.random.default_rng(4).integers(0, cfg.vocab, B).astype(np.int32)
    for pos in range(10):
        want, jc = step(params, jnp.asarray(tok), jc,
                        jnp.asarray(pos, jnp.int32))
        got, pc = port_m.decode_step(pp, torch.from_numpy(tok), pc, pos)
        close(got, want, RTOL[dtype]["logit"])
        tok = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)


T_VLM = dict(name="t_vlm", family="vlm", mm_positions=4, n_layers=4,
             d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
             param_dtype="float32", compute_dtype="float32")


def test_decode_matches_forward():
    """tests/test_models.py's vlm case on the port: greedy decode logits at
    position t equal the forward's of the same tokens without the stub
    prefix (rel 1e-4), with the reference's parameters."""
    cfg = ModelConfig(**T_VLM)
    model = build_model(cfg)
    params = convert.params_to_port(jax.tree.map(
        np.asarray, ref_build(RefModelConfig(**T_VLM)).init(
            jax.random.PRNGKey(0))), "cpu")
    n_check = 8
    tok = torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(2), (2, 16), 0, cfg.vocab)))
    cache = model.init_cache(2, 16, "cpu")
    logits = []
    for t in range(n_check):
        lg, cache = model.decode_step(params, tok[:, t], cache, t)
        logits.append(lg)
    dec = torch.stack(logits, 1)
    plain = build_model(dataclasses.replace(cfg, mm_positions=0))
    with torch.no_grad():
        fwd, _ = plain.forward(params, {"tokens": tok[:, :n_check]})
    rel = float((dec - fwd).abs().max()) / (float(fwd.abs().max()) + 1e-9)
    assert rel < 1e-4, rel


def vl_check_inputs():
    cfg = dataclasses.replace(registry.get_config(ARCH, reduced=True),
                              compute_dtype="bfloat16")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    batch = batch_for(cfg, 64, 2, 0).device_batch(0, "cpu")
    return cfg, params, batch


def test_vl_check_passes_the_port_at_bf16():
    """chip_smoke's vl i (the bf16 step, stub embeddings and all, against
    `chip_smoke.tr_plain_loss` in f32) passes at a reduced width, well
    inside its bounds (qk-norm keeps the attention soft)."""
    got = chip_smoke.tr_grad_check(*vl_check_inputs())
    assert got["ok"], got
    assert got["loss_rel_err"] <= chip_smoke.TR_LOSS_RTOL / 10
    assert 1 - got["min_grad_cos"] <= (1 - chip_smoke.TR_GRAD_COS) / 10


def test_vl_check_catches_a_missing_causal_mask():
    got = chip_smoke.tr_grad_check(*vl_check_inputs(), causal=False)
    assert not got["ok"], got


def test_vl_plain_loss_is_the_references_loss():
    """`chip_smoke.tr_plain_loss` with the stub prefix gives the
    reference's loss on the same weights and batch at f32."""
    ref_cfg, cfg, params, pp, jb, tb = setup("float32", seed=3)
    want, _ = ref_build(ref_cfg).loss(params, jb)
    got = chip_smoke.tr_plain_loss(cfg, pp, tb["tokens"], tb["mm_embeds"])
    close(got, want, RTOL["float32"]["loss"] * 10)
