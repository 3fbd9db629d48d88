"""What llama4-maverick's width asks of the port, held on the CPU at its
`reduced()` (and moonshot's): the routed FFN's expert stacks widened a
block of experts at a time (`moe.EXPERT_BLOCK_BYTES`), the init scaled in
place, chip_smoke's plain f32 forward widening a layer (a moe block's
experts one at a time) as it runs, and the mv h check.

At full width one of maverick's expert stacks is 10.74 GB in bf16 and
21.47 GB in f32; the blocks keep a product's f32 copy near 2 GiB.  Each
expert's product is the same whatever block it runs in, so every
comparison here is bit for bit (`torch.equal`), but the reference's, at
F32_RTOL of its largest magnitude as tests/test_torch_moe.py holds the
unblocked FFN.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro_torch import utils
from repro_torch.configs import registry
from repro_torch.models import moe, params as prm
from repro_torch.models.params import ParamDef
from repro_torch.models.transformer import build_model
from tests import _torch_ref as tr
from tests.test_torch_hybrid import F32_RTOL, close, rand
from tests.test_torch_moe import cfgs, ffn_params
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

MAVERICK = "llama4-maverick-400b-a17b"
MOONSHOT = "moonshot-v1-16b-a3b"
ARCHS = (MAVERICK, MOONSHOT)
# every model family with an h check in chip_smoke
H_ARCHS = ("qwen3-0.6b", "recurrentgemma-2b", "xlstm-1.3b", MOONSHOT,
           MAVERICK, "seamless-m4t-large-v2")


def experts_a_block(monkeypatch, cfg, n):
    """Blocks of `n` experts: the byte limit of n experts' f32 copy."""
    monkeypatch.setattr(moe, "EXPERT_BLOCK_BYTES",
                        n * 4 * cfg.d_model * cfg.moe.d_expert)


def moe_run(case, dtype, S, mesh_name, seed=3):
    """apply_moe's output, aux values and the gradients of a loss of both
    as to x and every FFN weight."""
    ref_cfg, cfg = cfgs(case, dtype)
    _, pp = ffn_params(ref_cfg)
    pp = utils.tree_map(lambda w: w.clone().requires_grad_(), pp)
    _, x = rand((4, S, cfg.d_model), seed, dtype)
    x = x.clone().requires_grad_()
    mesh = tr.zone_mesh(mesh_name) if mesh_name else None
    out, aux = moe.apply_moe(pp, x, cfg, mesh)
    w = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
    loss = (out.float() * w).sum() + aux["load_balance"] + aux["router_z"]
    loss.backward()
    return out.detach(), {k: v.detach() for k, v in aux.items()}, \
        [x.grad] + [p.grad for p in utils.tree_leaves(pp)]


# -- the blocked expert products ---------------------------------------------

def test_expert_blocks_at_full_width():
    """maverick's stacks (128 x 5120 x 8192) run in 11 blocks of at most
    12 experts, each block's f32 copy under the limit; moonshot's (64 x
    2048 x 1408, 0.74 GB in f32) in one."""
    for arch, want in ((MAVERICK, [12] * 10 + [8]), (MOONSHOT, [64])):
        cfg = registry.get_config(arch)
        w = torch.empty((cfg.moe.num_experts, cfg.d_model,
                         cfg.moe.d_expert), dtype=torch.bfloat16,
                        device="meta")
        blocks = moe._expert_blocks(w)
        assert [b.stop - b.start for b in blocks] == want
        assert blocks[0].start == 0 and blocks[-1].stop == w.shape[0]
        assert all(a.stop == b.start for a, b in zip(blocks, blocks[1:]))
        assert max(want) * 4 * math.prod(w.shape[1:]) \
            <= moe.EXPERT_BLOCK_BYTES


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("S,mesh_name", [(8, "mesh42"), (8, None),
                                         (1, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ARCHS)
def test_blocked_experts_give_the_same_bits(monkeypatch, case, dtype, S,
                                            mesh_name, n):
    """apply_moe with blocks of n experts (1: each expert its own; 3: an
    uneven split of 4 or 8) against one block: the output, the aux terms
    and every gradient bit for bit; in training (S = 8, in the mesh's
    groups or one) and decoding (S = 1)."""
    want = moe_run(case, dtype, S, mesh_name)
    _, cfg = cfgs(case, dtype)
    experts_a_block(monkeypatch, cfg, n)
    assert len(moe._expert_blocks(torch.empty(
        (cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert),
        device="meta"))) == math.ceil(cfg.moe.num_experts / n)
    got = moe_run(case, dtype, S, mesh_name)
    assert torch.equal(got[0], want[0])
    assert sorted(got[1]) == sorted(want[1])
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k
    for g, w in zip(got[2], want[2], strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ARCHS)
def test_one_block_is_the_unblocked_product(case, dtype):
    """A stack under the limit (every reduced one, and moonshot's at full
    width) runs as one block: `_experts` gives the bits of the products
    as they were written before the blocks, each stack widened whole,
    and so do the gradients as to the dispatch rows and the stacks."""
    ref_cfg, cfg = cfgs(case, dtype)
    _, pp = ffn_params(ref_cfg)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    assert len(moe._expert_blocks(pp["wi"])) == 1
    _, h = rand((2, cfg.moe.num_experts, 3, cfg.d_model), 5, dtype)
    outs = []
    for blocked in (True, False):
        p = {n: pp[n].clone().requires_grad_() for n in ("wi", "wg", "wo")}
        x = h.clone().requires_grad_()
        if blocked:
            y = moe._experts(p, x, dt)
        else:
            a = moe._expert_mm(x.float(), p["wi"].to(dt).float())
            gt = moe._expert_mm(x.float(), p["wg"].to(dt).float())
            y = moe._expert_mm((torch.nn.functional.silu(gt) * a).to(dt),
                               p["wo"].to(dt))
        y.float().pow(2).sum().backward()
        outs.append([y.detach(), x.grad] + [p[n].grad for n in sorted(p)])
    for g, w in zip(*outs, strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ARCHS)
def test_blocked_experts_match_the_reference(monkeypatch, case):
    """Each expert its own block, routed in the (4, 2) mesh's groups:
    the reference's output and aux values, within F32_RTOL."""
    ref_cfg, cfg = cfgs(case)
    jp, pp = ffn_params(ref_cfg)
    x, xt = rand((4, 8, cfg.d_model), 3)
    experts_a_block(monkeypatch, cfg, 1)
    want, waux = ref_moe.apply_moe(jp, x, ref_cfg, tr.jax_mesh("mesh42"))
    got, aux = moe.apply_moe(pp, xt, cfg, tr.zone_mesh("mesh42"))
    close(got, want, F32_RTOL)
    for k in waux:
        close(aux[k], waux[k], F32_RTOL)


# -- the init scaled in place ------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("init,scale", [("normal", 1.0), ("normal", 0.5),
                                        ("scaled", 0.02)])
def test_init_in_place_gives_the_old_bits(dtype, init, scale):
    """`_init_one` against `(x * std).to(dt)` from the same generator
    state, for a stacked and a flat leaf."""
    for shape in ((3, 64, 48), (64,)):
        d = ParamDef(shape, dtype, ("layers", "embed", "mlp")[-len(shape):],
                     init=init, scale=scale)
        got = prm._init_one(d, torch.Generator().manual_seed(7), "cpu")
        x = torch.randn(shape, generator=torch.Generator().manual_seed(7),
                        dtype=torch.float32)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = scale / math.sqrt(fan_in) if init == "normal" else scale
        want = (x * std).to(prm.torch_dtype(dtype))
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


# -- chip_smoke's plain forward, widened as it runs ----------------------------

def bf16_model(arch, n_layers=None):
    """A reduced config at bf16 weights and compute, its weights from a
    seed and as a server holds them (`compute_params`)."""
    cfg = dataclasses.replace(
        registry.get_config(arch, reduced=True), param_dtype="bfloat16",
        compute_dtype="bfloat16",
        **({"n_layers": n_layers} if n_layers else {}))
    model = build_model(cfg)
    return cfg, model.compute_params(
        model.init(torch.Generator().manual_seed(0), "cpu"))


@pytest.mark.parametrize("arch", H_ARCHS)
def test_lazy_widening_gives_the_eager_bits(arch):
    """`sv_plain_logits` on the bf16 weights (each layer widened as it
    runs, a moe block's experts one at a time) against the same forward
    on the whole tree widened first: bit for bit, and the expert choices
    alike."""
    import chip_smoke
    cfg, cp = bf16_model(arch)
    assert any(w.dtype == torch.bfloat16 for w in utils.tree_leaves(cp))
    wide = utils.tree_map(lambda w: w.float(), cp)
    rng = np.random.default_rng(4)
    seq = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 10)))
    kw = {}
    if cfg.enc_layers:
        kw["src"] = torch.from_numpy(
            rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32))
    rec_lazy, rec_eager = [], []
    lazy = chip_smoke.sv_plain_logits(cfg, cp, seq, record=rec_lazy, **kw)
    eager = chip_smoke.sv_plain_logits(cfg, wide, seq, record=rec_eager,
                                       **kw)
    assert lazy.dtype == torch.float32 and torch.isfinite(lazy).all()
    assert torch.equal(lazy, eager)
    assert len(rec_lazy) == len(rec_eager) == (
        cfg.n_layers // len(cfg.pattern) * cfg.pattern.count("moe"))
    for (a, ka), (b, kb) in zip(rec_lazy, rec_eager):
        assert torch.equal(a, b) and torch.equal(ka, kb)


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_moe_widens_an_expert_at_a_time(arch):
    """`plain_moe` on bf16 expert stacks (the rest of the block widened
    by `plain_layer`) against the same stacks widened first: the same
    bits; following its own choices changes nothing, and following others
    moves the output while the record keeps its own."""
    import chip_smoke
    cfg, cp = bf16_model(arch)
    key = next(k for k in cp["groups"] if k.endswith("_moe"))
    f = chip_smoke.plain_layer("moe", utils.tree_map(
        lambda w: w[0], cp["groups"][key]))["ffn"]
    assert f["wi"].dtype == torch.bfloat16
    assert f["shared"]["wi"].dtype == torch.float32
    wide = utils.tree_map(lambda w: w.float(), f)
    h = torch.randn(3, 5, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    rec = []
    got, aux = chip_smoke.plain_moe(f, h, cfg, record=rec)
    want, waux = chip_smoke.plain_moe(wide, h, cfg)
    assert torch.equal(got, want) and torch.equal(aux, waux)
    same, _ = chip_smoke.plain_moe(f, h, cfg, follow=rec[0][0])
    assert torch.equal(same, got)
    other = (rec[0][0] + 1) % cfg.moe.num_experts
    rec2 = []
    moved, _ = chip_smoke.plain_moe(f, h, cfg, record=rec2, follow=other)
    assert not torch.equal(moved, got)
    assert torch.equal(rec2[0][0], rec[0][0])


# -- the mv h check ------------------------------------------------------------

def mv_served(monkeypatch):
    """chip_smoke's mv model at maverick's reduced width (one ("dense",
    "moe") group, f32), an unprotected server's greedy tokens from a
    seeded prompt: (cfg, params, prompt, tokens)."""
    import chip_smoke
    from repro_torch import ProtectConfig, ZoneMesh
    from repro_torch.runtime.server import Server
    cfg = dataclasses.replace(registry.get_config(MAVERICK, reduced=True),
                              n_layers=chip_smoke.MV_LAYERS)
    assert cfg.pattern == ("dense", "moe")
    params = chip_smoke.hybrid_params(cfg, torch.device("cpu"))
    monkeypatch.setattr(chip_smoke, "MV_MAX_LEN", 24)
    monkeypatch.setattr(chip_smoke, "MV_H_CHUNK", 2)
    srv = Server(cfg, ProtectConfig(), ZoneMesh((4, 2), ("data", "model")),
                 batch=4, max_len=24, protect_cache=False, device="cpu")
    srv.start(params)
    prompt = torch.randint(0, cfg.vocab, (4, 6),
                           generator=torch.Generator().manual_seed(1))
    return cfg, params, prompt, srv.generate(prompt, 10)


def mv_h(monkeypatch, follow):
    """mv h on the reduced model (`mv_reference` follows the decode's
    routes; `moe_reference` at mv's sizes on the f32 forward's own)."""
    import chip_smoke
    served = mv_served(monkeypatch)
    if follow:
        return chip_smoke.mv_reference(*served)
    return chip_smoke.moe_reference(*served, chip_smoke.MV_MAX_LEN,
                                    chip_smoke.MV_H_CHUNK)


@pytest.mark.parametrize("follow", [False, True])
def test_mv_h_passes_the_port(monkeypatch, follow):
    """mv h end to end on the reduced model, compared two sequences a
    pass: the served tokens teacher-forced through the decode against
    the f32 forward on its own routes or on the decode's, within 2^-4;
    every expert choice made alike, none differing."""
    got = mv_h(monkeypatch, follow)
    assert got["positions_over_bound"] == 0
    assert got["expert_choice_agreement"] == 1.0
    assert got["expert_choices"] == 4 * 15
    assert got["expert_choices_differing"] == 0
    assert got["routing"] == ("the decode's" if follow else "its own")


@pytest.mark.parametrize("follow", [False, True])
def test_mv_h_catches_a_wrong_router(monkeypatch, follow):
    """The port's router planted to take each token's second expert
    before it serves: mv h fails, on the logits or (following the
    decode's routes) on the choices made alike."""
    from tests.test_torch_moe_model import plant_a_wrong_router
    plant_a_wrong_router(monkeypatch)
    with pytest.raises(AssertionError, match="h: "):
        mv_h(monkeypatch, follow)
