"""The moe family's whole model against the reference's: moonshot's
`reduced()` (3 layers of ("moe",), top-2 of 8 experts + shared, so three
checkpointed groups) and maverick's (interleave 2: ("dense", "moe") x 2,
top-1 of 4 + shared, behind a 4-position stub prefix) and the
tests/test_models.py families moe_top1 / moe_top2: forward, loss (ce +
z + 0.01 x the summed load-balance and router-z aux), gradients and the
teacher-forced decode; `count_params(active_only=)` for all twelve
configs.  Routing runs in the (4, 2) mesh's 4 data-shard groups where the
model has that mesh.  The FFN module is in tests/test_torch_moe.py, the
Server and the Trainer in tests/test_torch_moe_runtime.py.

Tolerances, of the largest magnitude: f32 loss and aux within 1e-6,
forward logits within MODEL_F32 = 1e-4; a 12-step decode, each package
carrying its own cache, its logits and the K/V it leaves within
MOE_DECODE = 1e-3 (measured 1.9e-4 on both); gradients within
MOE_GRAD = 2e-3 at a cosine of 1 - 1e-6 a leaf.  The reduced configs'
(d, heads, head_dim) projections take `heads` as their fan-in, so the
softmax is nearly one-hot and amplifies each last-bit difference: the
reference's own gradients move by 1.9e-4 between its jitted and op-by-op
runs, the port's sit 7.2e-4 from the jitted ones (measured).  Servers and
trainers are compared byte for byte on the same decode / step outputs,
as in tests/test_torch_hybrid_runtime.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import api as ref_api
from repro.models import moe as ref_moe
from repro.models.transformer import build_model as ref_build
from repro_torch import convert, utils
from repro_torch.configs import registry
from repro_torch.models import api
from repro_torch.models.transformer import build_model
from tests import _torch_ref as tr
from tests.test_torch_hybrid import close, same_grads
from tests.test_torch_moe import FAMILIES, cfgs
from tests._torch_ref import compile_cache, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("compile_cache", "one_thread")

MODEL_F32 = 1e-4
MOE_DECODE = 1e-3
MOE_GRAD = {"grad": 2e-3, "cos": 1 - 1e-6}
ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b")
CASES = ARCHS + tuple(FAMILIES)
ALL = ("llama4-maverick-400b-a17b", "moonshot-v1-16b-a3b",
       "seamless-m4t-large-v2", "chameleon-34b", "recurrentgemma-2b",
       "xlstm-1.3b", "minitron-8b", "qwen2-0.5b", "glm4-9b", "qwen3-0.6b")


@pytest.fixture(autouse=True)
def _f32_dots(monkeypatch):
    tr.f32_dots(monkeypatch, ref_moe)


def batch_of(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.mm_positions:
        b["mm_embeds"] = rng.standard_normal(
            (B, cfg.mm_positions, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def models(case, mesh_name=None):
    ref_cfg, cfg = cfgs(case)
    jm = tr.jax_mesh(mesh_name) if mesh_name else None
    zm = tr.zone_mesh(mesh_name) if mesh_name else None
    ref_m, port_m = ref_build(ref_cfg, jm), build_model(cfg, zm)
    params = ref_m.init(jax.random.PRNGKey(0))
    return ref_m, port_m, params, convert.params_to_port(
        jax.tree.map(np.asarray, params), "cpu")


@pytest.mark.parametrize("mesh_name", [None, "mesh42"])
@pytest.mark.parametrize("case", CASES)
def test_loss_aux_and_gradients_match_the_reference(case, mesh_name):
    """The loss, its terms, the aux (the moe blocks' load balance and
    router z summed over groups and tail) weighed 0.01 into the loss, and
    the gradients; routed in one group, or the mesh's four."""
    ref_m, port_m, jp, pp = models(case, mesh_name)
    jb, pb = batch_of(port_m.cfg)
    (want, wm), wg = jax.jit(jax.value_and_grad(ref_m.loss, has_aux=True))(
        jp, jb)
    got, gm, gg = api.make_loss_and_grads(port_m)(pp, pb)
    close(got, want, 1e-6)
    for k in ("ce", "z_loss", "aux"):
        close(gm[k], wm[k], 1e-6)
    assert float(gm["aux"]) > 0
    close(got, gm["ce"] + gm["z_loss"] + 0.01 * gm["aux"], 1e-7)
    same_grads(gg, wg, MOE_GRAD)


@pytest.mark.parametrize("case", ARCHS)
def test_forward_matches_the_reference(case):
    ref_m, port_m, jp, pp = models(case, "mesh42")
    jb, pb = batch_of(port_m.cfg, seed=1)
    want, waux = jax.jit(ref_m.forward)(jp, jb)
    with torch.no_grad():
        got, aux = port_m.forward(pp, pb)
    close(got, want, MODEL_F32)
    close(aux, waux, 1e-6)


@pytest.mark.parametrize("case", CASES)
def test_decode_step_teacher_forced(case):
    """Logits step by step over 12 positions (each step one group, its
    capacity the batch), both fed the reference's greedy tokens, each
    carrying its own KV cache; the caches agree at the end."""
    ref_m, port_m, jp, pp = models(case)
    step = jax.jit(ref_m.decode_step)
    B, T = 3, 16
    jc, pc = ref_m.init_cache(B, T), port_m.init_cache(B, T, device="cpu")
    tok = np.random.default_rng(5).integers(0, port_m.cfg.vocab, B).astype(
        np.int32)
    for pos in range(12):
        want, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(pos, jnp.int32))
        got, pc = port_m.decode_step(pp, torch.from_numpy(tok), pc, pos)
        close(got, want, MOE_DECODE)
        tok = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
    for want, got in zip(jax.tree.leaves(jc), utils.tree_leaves(pc),
                         strict=True):
        close(got, want, MOE_DECODE)


def test_compute_params_keep_the_router_in_f32():
    ref_cfg, cfg = cfgs("moonshot-v1-16b-a3b", "bfloat16")
    pp = convert.params_to_port(jax.tree.map(np.asarray, ref_build(
        ref_cfg).init(jax.random.PRNGKey(0))), "cpu")
    ffn = build_model(cfg).compute_params(pp)["groups"]["b0_moe"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    for n in ("wi", "wg", "wo"):
        assert ffn[n].dtype == torch.bfloat16
        assert ffn["shared"][n].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ALL)
def test_count_params_active_only(arch):
    """Every config, published and reduced: the total and the active
    count (an expert stack at top_k of num_experts) equal the
    reference's."""
    for reduced in (False, True):
        ref = ref_registry.get_config(arch, reduced=reduced)
        port = registry.get_config(arch, reduced=reduced)
        for active in (False, True):
            assert api.count_params(port, active_only=active) == \
                ref_api.count_params(ref, active_only=active)
        assert port.active_param_count() == ref.active_param_count()
    if arch == "seamless-m4t-large-v2":
        assert api.count_params(registry.get_config(arch)) == 2_034_784_256
    if arch == "moonshot-v1-16b-a3b":
        port = registry.get_config(arch)
        assert api.count_params(port) == 28_473_231_360
        assert port.active_param_count() == 4_383_836_160


def test_decode_matches_forward():
    """tests/test_models.py's moe cases on the port: greedy decode logits
    at position t equal the forward's at t (rel 1e-4) at its capacity
    factor 4, where the forward drops no token."""
    for case in FAMILIES:
        _, port_m, _, params = models(case)
        cfg = port_m.cfg
        B, T, n_check = 2, 16, 8
        tok = torch.from_numpy(np.array(jax.random.randint(
            jax.random.PRNGKey(2), (B, T), 0, cfg.vocab)))
        cache = port_m.init_cache(B, T, "cpu")
        logits = []
        for t in range(n_check):
            lg, cache = port_m.decode_step(params, tok[:, t], cache, t)
            logits.append(lg)
        dec = torch.stack(logits, 1)
        with torch.no_grad():
            fwd, _ = port_m.forward(params, {"tokens": tok[:, :n_check]})
        rel = float((dec - fwd).abs().max()) / (float(fwd.abs().max()) +
                                                 1e-9)
        assert rel < 1e-4, (case, rel)


# -- chip_smoke's mo h / mt i checks on the CPU ----------------------------------

@pytest.mark.parametrize("groups", [None, 4])
def test_plain_moe_matches_the_port(groups):
    """chip_smoke's f32 routed FFN (`plain_moe`, written apart from the
    port: a loop over experts) against the port's `apply_moe`, every
    choice kept and in 4 groups at capacity factor 0.5 (copies dropped):
    the output, the aux terms and the choices."""
    import chip_smoke
    ref_cfg, cfg = cfgs("moonshot-v1-16b-a3b", capacity_factor=0.5)
    from tests.test_torch_moe import ffn_params
    _, pp = ffn_params(ref_cfg)
    x = torch.randn(4, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    mesh = tr.zone_mesh("mesh42") if groups else None
    with torch.no_grad(), chip_smoke.RouteRecorder() as rec:
        want, aux = moe_mod().apply_moe(pp, x, cfg, mesh)
    # decode semantics keep every choice: the port's at S = 1
    record = []
    got, got_aux = chip_smoke.plain_moe(pp, x, cfg, groups, record=record)
    if groups is None:
        with torch.no_grad():
            want = torch.cat([moe_mod().apply_moe(pp, x[:, t:t + 1], cfg)[0]
                              for t in range(8)], 1)
    else:
        assert chip_smoke.choice_agreement(rec.calls, record) == 1.0
        assert not bool(record[0][1].all())
        close(got_aux, aux["load_balance"] + aux["router_z"], 1e-6)
    close(got, want, MODEL_F32)


def moe_mod():
    from repro_torch.models import moe
    return moe


def mt_check_inputs(dtype):
    import chip_smoke
    from repro_torch.data.synthetic import batch_for
    cfg = dataclasses.replace(registry.get_config("moonshot-v1-16b-a3b",
                                                  reduced=True),
                              n_layers=2, compute_dtype=dtype)
    params = chip_smoke.hybrid_params(cfg, torch.device("cpu"))
    batch = batch_for(cfg, 32, 2, 0).device_batch(0, "cpu")
    return cfg, params, batch, tr.zone_mesh("mesh42")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mt_check_passes_the_port(dtype):
    """mt i's check on moonshot's reduced config at two layers, routed in
    the (4, 2) mesh's groups: inside its bounds, the plain step on its own
    router, the choices made alike above the floor; at f32 every one."""
    import chip_smoke
    got = chip_smoke.tr_grad_check(*mt_check_inputs(dtype))
    assert got["ok"], got
    assert got["router_agreement"] >= chip_smoke.ROUTER_AGREEMENT
    if dtype == "float32":
        assert got["router_agreement"] == 1.0


def test_mt_check_catches_a_missing_aux_weight():
    """The plain loss weighs the aux 0.01: with the port's weight at 0,
    the losses part."""
    import chip_smoke
    from repro_torch.models import transformer
    cfg, params, batch, mesh = mt_check_inputs("float32")
    real = transformer.MOE_AUX_WEIGHT
    transformer.MOE_AUX_WEIGHT = 0.0
    try:
        got = chip_smoke.tr_grad_check(cfg, params, batch, mesh)
    finally:
        transformer.MOE_AUX_WEIGHT = real
    assert got["loss_rel_err"] > 1e-4, got


def plant_a_wrong_router(monkeypatch):
    """The port's router takes each token's k+1-th expert in place of its
    k-th (its gate renormalized over the experts it takes)."""
    real = moe_mod().top_k

    def top_k(probs, k):
        vals, idx = real(probs, k + 1)
        cols = [*range(k - 1), k]
        return vals[..., cols], idx[..., cols]
    monkeypatch.setattr(moe_mod(), "top_k", top_k)


def test_mt_check_catches_a_wrong_router(monkeypatch):
    """A port router that swaps each token's last expert for the next
    one: the share of choices made alike falls under the floor, so mt i
    fails (its loss moves by 6.6e-4 only, inside the loss bound)."""
    import chip_smoke
    plant_a_wrong_router(monkeypatch)
    got = chip_smoke.tr_grad_check(*mt_check_inputs("float32"))
    assert got["router_agreement"] < chip_smoke.ROUTER_AGREEMENT, got
    assert not got["ok"]


def served_tokens(monkeypatch, dtype):
    """The reduced moonshot at `dtype`, an unprotected server's greedy
    tokens from a seeded prompt: (cfg, params, prompt, tokens)."""
    import chip_smoke
    from repro_torch import ProtectConfig, ZoneMesh
    from repro_torch.runtime.server import Server
    cfg, params, _, _ = mt_check_inputs(dtype)
    monkeypatch.setattr(chip_smoke, "MO_MAX_LEN", 24)
    srv = Server(cfg, ProtectConfig(), ZoneMesh((4, 2), ("data", "model")),
                 batch=4, max_len=24, protect_cache=False, device="cpu")
    srv.start(params)
    prompt = torch.randint(0, cfg.vocab, (4, 6),
                           generator=torch.Generator().manual_seed(1))
    return cfg, params, prompt, srv.generate(prompt, 10)


def test_mo_h_passes_the_port(monkeypatch):
    """mo h end to end on the reduced model: an unprotected server's
    greedy tokens teacher-forced through the decode against the f32
    forward (every choice kept), within 2^-4; every expert choice made
    alike.  At f32 compute: at bf16 the reduced model's top 2 of 8
    experts swap at 2 of 60 positions, and there its logits (the largest
    0.66) move 0.26 of the largest off the f32 forward's own routing;
    the card's mo h holds the served bf16 decode."""
    import chip_smoke
    got = chip_smoke.mo_reference(*served_tokens(monkeypatch, "float32"))
    assert got["positions_over_bound"] == 0
    assert got["expert_choice_agreement"] == 1.0


def test_mo_h_catches_a_wrong_router(monkeypatch):
    """The same with the wrong router planted in the port before it
    serves (so the decode's argmax still gives its own tokens): mo h
    fails."""
    import chip_smoke
    plant_a_wrong_router(monkeypatch)
    with pytest.raises(AssertionError, match="h: "):
        chip_smoke.mo_reference(*served_tokens(monkeypatch, "float32"))
