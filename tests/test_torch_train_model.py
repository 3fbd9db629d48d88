"""The port's training model (`Model.hidden` / `forward` / `loss`, the
chunked CE, `api.make_train_step` / `make_forward` / `make_prefill`)
against the reference's, on the same numpy parameters and batches at
reduced sizes, and chip_smoke's tr i check on the CPU.

Losses and logits are held to a stated share of the reference's largest
magnitude, gradients to a cosine with the reference's (every leaf) and a
max error as a share of the leaf's largest |gradient|: f32 within
F32_RTOL (the reduced models read 8e-8 on the loss, 8e-6 on a gradient);
the compute dtype bf16 within BF16_RTOL (the reference rounds each cast
to bf16 as the port does, but the f32 sums between roundings run in
another order, so values a few bf16 units apart compound through two
layers and the backward: the reduced models read 4e-6 on the loss, 0.021
on a gradient and a cosine of 0.99984 or more).  Logits and the hidden
state, one value a position, are held to LOGIT_RTOL: at bf16 the four
bf16 units of tests/test_torch_models.py's decode logits (here 0.0063).
A train step that gives the same bits on every run is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.models import api as ref_api
from repro.models.transformer import build_model as ref_build
from repro.optim import build_optimizer as ref_build_optimizer
from repro_torch import convert, utils
from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.data.synthetic import batch_for
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models.transformer import build_model
from repro_torch.optim import build_optimizer

import chip_smoke
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

F32_RTOL = {"loss": 1e-6, "grad": 2e-5, "cos": 1 - 1e-9}
BF16_RTOL = {"loss": 1e-4, "grad": 2 ** -5, "cos": 0.999}
RTOL = {"float32": F32_RTOL, "bfloat16": BF16_RTOL}
LOGIT_RTOL = {"float32": 1e-5, "bfloat16": 2 ** -6}
ARCHS = ("qwen3-0.6b", "qwen2-0.5b")
DTYPES = ("float32", "bfloat16")
S, B = 32, 4


def cfgs(arch, dtype):
    ref = dataclasses.replace(ref_registry.get_config(arch, reduced=True),
                              compute_dtype=dtype)
    port = dataclasses.replace(registry.get_config(arch, reduced=True),
                               compute_dtype=dtype)
    return ref, port


def setup(arch, dtype, seed=0):
    ref_cfg, cfg = cfgs(arch, dtype)
    params = ref_build(ref_cfg).init(jax.random.PRNGKey(seed))
    np_params = jax.tree.map(np.asarray, params)
    tokens = batch_for(cfg, S, B, seed).batch_at(seed)["tokens"]
    return (ref_cfg, cfg, params, convert.params_to_port(np_params, "cpu"),
            tokens)


def close(got, want, rtol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * max(float(np.abs(want).max()), 1e-30), err


def same_grads(got, want, rtol):
    for a, b in zip(utils.tree_leaves(got), jax.tree.leaves(want),
                    strict=True):
        x = a.double().reshape(-1).numpy()
        y = np.asarray(b, np.float64).reshape(-1)
        assert x @ y / np.linalg.norm(x) / np.linalg.norm(y) >= rtol["cos"]
        close(a, b, rtol["grad"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(arch, dtype):
    ref_cfg, cfg, params, pp, tok = setup(arch, dtype)
    (want, wm), wg = jax.value_and_grad(ref_build(ref_cfg).loss,
                                        has_aux=True)(
        params, {"tokens": jnp.asarray(tok)})
    got, gm, gg = api.make_loss_and_grads(build_model(cfg))(
        pp, {"tokens": torch.from_numpy(tok)})
    rtol = RTOL[dtype]
    close(got, want, rtol["loss"])
    for k in ("ce", "z_loss"):
        close(gm[k], wm[k], rtol["loss"])
    assert float(gm["aux"]) == float(wm["aux"]) == 0.0
    same_grads(gg, wg, rtol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_and_prefill_match_the_reference(dtype):
    ref_cfg, cfg, params, pp, tok = setup("qwen3-0.6b", dtype, seed=1)
    ref_model, model = ref_build(ref_cfg), build_model(cfg)
    batch, tbatch = {"tokens": jnp.asarray(tok)}, {
        "tokens": torch.from_numpy(tok)}
    rtol = LOGIT_RTOL[dtype]
    with torch.no_grad():
        close(api.make_forward(model)(pp, tbatch),
              ref_api.make_forward(ref_model)(params, batch), rtol)
        close(api.make_prefill(model)(pp, tbatch),
              ref_api.make_prefill(ref_model)(params, batch), rtol)
        x, aux = model.hidden(pp, tbatch)
    wx, _ = ref_model.hidden(params, batch)
    close(x, wx, rtol)


def states(arch, dtype, optimizer="adamw"):
    ref_cfg, cfg, params, pp, tok = setup(arch, dtype, seed=2)
    rtc = RefTrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=100,
                         optimizer=optimizer)
    ptc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=100,
                      optimizer=optimizer)
    ro, po = ref_build_optimizer(rtc, ref_cfg), build_optimizer(ptc, cfg)
    rs = ref_api.init_train_state(ref_build(ref_cfg), ro,
                                  jax.random.PRNGKey(2))
    ps = convert.train_state_to_port(jax.tree.map(np.asarray, rs), "cpu")
    return ref_cfg, cfg, (ro, rtc, rs), (po, ptc, ps)


@pytest.mark.parametrize("microbatches", [1, 2, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_train_steps_match_the_reference(dtype, microbatches):
    ref_cfg, cfg, (ro, rtc, rs), (po, ptc, ps) = states("qwen3-0.6b", dtype)
    rtc = dataclasses.replace(rtc, microbatches=microbatches)
    ptc = dataclasses.replace(ptc, microbatches=microbatches)
    rstep = jax.jit(ref_api.make_train_step(ref_build(ref_cfg), ro, rtc))
    pstep = api.make_train_step(build_model(cfg), po, ptc)
    stream = batch_for(cfg, S, B, 0)
    rtol = RTOL[dtype]
    for cursor in range(3):
        tok = stream.batch_at(cursor)["tokens"]
        rs, rm = rstep(rs, {"tokens": jnp.asarray(tok)})
        ps, pm = pstep(ps, {"tokens": torch.from_numpy(tok)})
        assert pm.keys() == rm.keys()
        close(pm["loss"], rm["loss"], rtol["loss"])
        close(pm["grad_norm"], rm["grad_norm"], rtol["grad"])
        assert int(ps["step"]) == int(rs["step"]) == cursor + 1
        assert ps["step"].dtype == torch.int32
    for a, b in zip(utils.tree_leaves(ps["params"]),
                    jax.tree.leaves(rs["params"]), strict=True):
        close(a, b, rtol["grad"])


def test_adafactor_train_step_matches_the_reference():
    ref_cfg, cfg, (ro, rtc, rs), (po, ptc, ps) = states(
        "qwen3-0.6b", "float32", "adafactor")
    rstep = jax.jit(ref_api.make_train_step(ref_build(ref_cfg), ro, rtc))
    pstep = api.make_train_step(build_model(cfg), po, ptc)
    tok = batch_for(cfg, S, B, 0).batch_at(0)["tokens"]
    rs, rm = rstep(rs, {"tokens": jnp.asarray(tok)})
    ps, pm = pstep(ps, {"tokens": torch.from_numpy(tok)})
    close(pm["loss"], rm["loss"], F32_RTOL["loss"])
    for a, b in zip(utils.tree_leaves(ps), jax.tree.leaves(rs), strict=True):
        close(a, b, F32_RTOL["grad"])


@pytest.mark.parametrize("dropped", [[1], [0, 3]])
def test_loss_mask_leaves_loss_and_gradients_unchanged(dropped):
    """The reference's re-weighting `loss * w / max(w, 1e-9)` is the loss
    itself for any w > 1e-9: dropping a straggler's replica changes no
    gradient (a reference fault, reproduced on purpose; ROADMAP queue C).
    Here the gradient scale w / w rounds to exactly 1, so the masked step
    is the unmasked step, bit for bit, and its loss the unmasked loss
    re-weighted (one rounding)."""
    ref_cfg, cfg, (ro, rtc, rs), (po, ptc, ps) = states("qwen3-0.6b",
                                                        "float32")
    mask = np.ones(B, np.float32)
    for r in dropped:
        mask[r] = 0.0
    tok = torch.from_numpy(batch_for(cfg, S, B, 0).batch_at(0)["tokens"])
    pstep = api.make_train_step(build_model(cfg), po, ptc)
    plain, pm = pstep(ps, {"tokens": tok})
    masked, mm = pstep(ps, {"tokens": tok,
                            "loss_mask": torch.from_numpy(mask)})
    w = torch.tensor(mask).mean()
    assert float(mm["loss"]) == float(pm["loss"] * w / w)
    assert abs(float(mm["loss"]) - float(pm["loss"])) <= 1e-6 * float(
        pm["loss"])
    for a, b in zip(utils.tree_leaves(masked), utils.tree_leaves(plain)):
        assert torch.equal(a, b)
    # the reference's masked loss is its unmasked loss, as the port's
    rstep = jax.jit(ref_api.make_train_step(ref_build(ref_cfg), ro, rtc))
    _, rmm = rstep(rs, {"tokens": jnp.asarray(tok.numpy()),
                        "loss_mask": jnp.asarray(mask)})
    _, rpm = rstep(rs, {"tokens": jnp.asarray(tok.numpy())})
    assert abs(float(rmm["loss"]) - float(rpm["loss"])) <= 1e-6 * float(
        rpm["loss"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_train_step_gives_the_same_bits_every_run(dtype):
    _, cfg, _, (po, ptc, ps) = states("qwen3-0.6b", dtype)
    step = api.make_train_step(build_model(cfg), po, ptc)
    tok = torch.from_numpy(batch_for(cfg, S, B, 0).batch_at(0)["tokens"])
    a, am = step(ps, {"tokens": tok})
    b, bm = step(ps, {"tokens": tok})
    assert float(am["loss"]) == float(bm["loss"])
    for x, y in zip(utils.tree_leaves(a), utils.tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("rows", [1, 7, 50])
def test_row_sums_is_index_add(rows):
    """The embedding's deterministic backward sums the same rows as
    `index_add_` (in f64, then rounded once)."""
    rng = np.random.default_rng(rows)
    idx = torch.from_numpy(rng.integers(0, rows, (3, 40)))
    g = torch.from_numpy(rng.standard_normal((3, 40, 6)).astype(np.float32))
    want = torch.zeros(rows, 6, dtype=torch.float64).index_add_(
        0, idx.reshape(-1), g.reshape(-1, 6).double()).float()
    got = L.row_sums(g, idx, rows)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, L.row_sums(g, idx, rows))


def test_hidden_checkpoints_each_group(monkeypatch):
    """With more than one layer group, each group runs under
    torch.utils.checkpoint: the forward keeps each group's input, not its
    activations, so it saves under half of what the same forward saves
    without checkpointing."""
    from repro_torch.models import transformer
    _, cfg, _, _, tok = setup("qwen3-0.6b", "float32")
    model = build_model(dataclasses.replace(cfg, n_layers=4))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.from_numpy(tok)}

    def saved_bytes():
        sizes = []

        def pack(t):
            sizes.append(t.numel() * t.element_size())
            return t
        xs = utils.tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model.loss(xs, batch)
        return sum(sizes)
    remat = saved_bytes()
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda fn, *args, **kw: fn(*args))
    assert remat < saved_bytes() / 2


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_state_and_batch_specs_match_the_reference(optimizer):
    """`abstract_train_state` (meta tensors) has the reference's shapes and
    dtypes leaf for leaf, and `train_state_specs` / `batch_specs` its
    specs, on the (4, 2) mesh."""
    from jax.sharding import PartitionSpec
    from tests import _torch_ref as tr
    ref_cfg, cfg = cfgs("qwen3-0.6b", "float32")
    ro = ref_build_optimizer(RefTrainConfig(optimizer=optimizer), ref_cfg)
    po = build_optimizer(TrainConfig(optimizer=optimizer), cfg)
    rm, pm = ref_build(ref_cfg), build_model(cfg)
    want = jax.tree.leaves(ref_api.abstract_train_state(rm, ro))
    got = utils.tree_leaves(api.abstract_train_state(pm, po))
    assert [(tuple(a.shape), str(a.dtype)) for a in want] == [
        (tuple(b.shape), str(b.dtype).split(".")[-1]) for b in got]
    assert all(b.is_meta for b in got)
    mesh, zmesh = tr.jax_mesh("mesh42"), tr.zone_mesh("mesh42")

    def flat(tree):
        return [tuple(s) for s in jax.tree.leaves(
            tree, is_leaf=lambda x: isinstance(x, PartitionSpec))]
    assert flat(ref_api.train_state_specs(rm, ro, mesh)) == [
        tuple(s) for s in utils.tree_leaves(
            api.train_state_specs(pm, po, zmesh))]
    assert flat(ref_api.batch_specs(ref_cfg, mesh)) == [
        tuple(s) for s in utils.tree_leaves(api.batch_specs(cfg, zmesh))]


# -- chip_smoke's tr i on the CPU ------------------------------------------------

def tr_check_inputs():
    cfg = dataclasses.replace(registry.get_config("qwen3-0.6b", reduced=True),
                              compute_dtype="bfloat16")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    batch = batch_for(cfg, 128, 4, 0).device_batch(0, "cpu")
    return cfg, params, batch


def test_tr_check_passes_the_port_at_bf16():
    """tr i's check (the bf16 train step against `chip_smoke.tr_plain_loss`
    in f32) passes the port at a reduced width, well inside its bounds."""
    got = chip_smoke.tr_grad_check(*tr_check_inputs())
    assert got["ok"], got
    assert got["loss_rel_err"] <= chip_smoke.TR_LOSS_RTOL / 10
    assert 1 - got["min_grad_cos"] <= (1 - chip_smoke.TR_GRAD_COS) / 10


@pytest.mark.parametrize("fault", [{"kv_roll": 1}, {"causal": False},
                                   {"theta": 1e4}],
                         ids=["wrong_kv_head", "no_causal_mask", "theta_1e4"])
def test_tr_check_catches_faults(fault):
    """A wrong KV head, a missing causal mask and a rope θ of 1e4 (planted
    in the plain forward) each fail tr i's bounds."""
    got = chip_smoke.tr_grad_check(*tr_check_inputs(), **fault)
    assert not got["ok"], got
    assert got["min_grad_cos"] < chip_smoke.TR_GRAD_COS


def test_tr_plain_loss_is_the_references_loss():
    """`chip_smoke.tr_plain_loss` (f32, dense attention, no chunks) gives
    the reference's loss on the same weights at f32."""
    ref_cfg, cfg, params, pp, tok = setup("qwen3-0.6b", "float32", seed=3)
    want, _ = ref_build(ref_cfg).loss(params, {"tokens": jnp.asarray(tok)})
    got = chip_smoke.tr_plain_loss(cfg, pp, torch.from_numpy(tok))
    close(got, want, F32_RTOL["loss"] * 10)
