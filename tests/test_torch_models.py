"""The port's model plane (repro_torch.configs, .models, dist.sharding's
spec_for, core.layout's time-slice helpers) against the reference's, on
the same numpy inputs at reduced sizes.

Float results are held to stated tolerances, scaled by the largest
magnitude of the reference's result: f32 within 1e-5 relative, and the
compute dtype bf16 within `BF16_RTOL` (two bf16 units in the last place:
a product rounded to bf16 in both packages may land one unit apart after
f32 sums in another order, and a second rounding downstream may add
one).  A whole decode step through every layer compounds those roundings,
so `Model.decode_step`'s logits are held to `STEP_RTOL` at bf16 (four
bf16 units: the reduced models read 0.0058-0.0069 of the largest logit),
teacher-forced on the reference's tokens.  Specs, cache copies and
time-slice footprints are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from repro.configs import registry as ref_registry
from repro.core import layout as ref_layout
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blocks
from repro.models import layers as ref_L
from repro.models import api as ref_api
from repro.models.transformer import build_model as ref_build
from repro_torch import convert, utils
from repro_torch.configs import registry
from repro_torch.core import layout
from repro_torch.dist import sharding
from repro_torch.models import api, attention, blocks
from repro_torch.models import layers as L
from repro_torch.models import params as prm
from repro_torch.models.transformer import build_model
from tests import _torch_ref as tr

import chip_smoke
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

F32_RTOL = 1e-5
BF16_RTOL = 2 ** -7
STEP_RTOL = {"float32": 1e-5, "bfloat16": 2 ** -6}
ARCHS = ("qwen3-0.6b", "qwen2-0.5b")
DTYPES = ("float32", "bfloat16")


def cfgs(arch, dtype):
    """(reference config, port config): `reduced()` at compute `dtype`."""
    ref = dataclasses.replace(ref_registry.get_config(arch, reduced=True),
                              compute_dtype=dtype)
    port = dataclasses.replace(registry.get_config(arch, reduced=True),
                               compute_dtype=dtype)
    return ref, port


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


def rand(shape, seed, dtype="float32"):
    """A seeded standard-normal array, rounded to `dtype` by JAX; returns
    (jnp array, port CPU tensor) with the same bits."""
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape)
                    .astype(np.float32)).astype(dtype)
    return x, convert._leaf(np.asarray(x), "cpu")


def close(got, want, rtol):
    want = np.asarray(want).astype(np.float64)
    got = got.float().numpy().astype(np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def rtol(dtype):
    return F32_RTOL if dtype == "float32" else BF16_RTOL


def layer0(np_params):
    """The first layer's block parameters (the stacked groups at 0)."""
    return jax.tree.map(lambda x: x[0], np_params["groups"]["b0_dense"])


def both(tree):
    """numpy tree -> (jnp tree, port CPU tree)."""
    return (jax.tree.map(jnp.asarray, tree),
            convert.params_to_port(tree, "cpu"))


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ref_registry.list_archs())
def test_configs_equal_the_reference(arch, reduced):
    assert registry.list_archs() == ref_registry.list_archs()
    ref = ref_registry.get_config(arch, reduced=reduced)
    port = registry.get_config(arch, reduced=reduced)
    want = dataclasses.asdict(ref)
    got = dataclasses.asdict(port)
    assert got == want
    assert (port.hd, port.pattern, port.n_groups, port.tail_pattern) == (
        ref.hd, ref.pattern, ref.n_groups, ref.tail_pattern)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count(arch):
    ref = ref_registry.get_config(arch)
    port = registry.get_config(arch)
    assert port.param_count() == ref.param_count()
    assert api.count_params(port) == ref_api.count_params(ref)
    if arch == "qwen3-0.6b":
        # 28 x 15,730,944 a layer + 155,582,464 embedding + 1,024 norm
        assert port.param_count() == 596_049_920


# -- spec_for -------------------------------------------------------------------

def _spec_pairs(ref_tree, port_tree):
    ref_leaves = jax.tree.leaves(
        ref_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return zip(ref_leaves, utils.tree_leaves(port_tree), strict=True)


@pytest.mark.parametrize("mesh_name", ["mesh42", "mesh81"])
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_matches_the_reference(arch, reduced, mesh_name):
    """Every leaf of param_defs and cache_specs gets the reference's spec
    (divisibility fallback included: qwen3's 8 KV heads land on `model`
    at (4, 2), qwen2's 2 on (8, 1)'s size-1 axis)."""
    mesh, zmesh = tr.jax_mesh(mesh_name), tr.zone_mesh(mesh_name)
    ref_m = ref_build(ref_registry.get_config(arch, reduced=reduced), mesh)
    port_m = build_model(registry.get_config(arch, reduced=reduced), zmesh)
    for want, got in _spec_pairs(ref_m.param_specs(mesh),
                                 port_m.param_specs(zmesh)):
        assert tuple(got) == tuple(want)
    for want, got in _spec_pairs(ref_m.cache_specs(16, 2048, mesh),
                                 port_m.cache_specs(16, 2048, zmesh)):
        assert tuple(got) == tuple(want)


def test_spec_for_rules_and_fallback():
    """The candidate order, double-booking and overrides, directly."""
    from jax.sharding import PartitionSpec
    from repro.dist import sharding as ref_shd
    for name in ("mesh42", "mesh81", "mesh_pod"):
        mesh, zmesh = tr.jax_mesh(name), tr.zone_mesh(name)
        for logical, shape, rules in [
                (("batch", "embed"), (16, 64), None),
                (("batch", "batch"), (16, 16), None),
                (("heads", "kv_heads"), (4, 4), None),
                (("vocab", None, "ffn"), (3, 5, 6), None),
                (("batch", "heads"), (6, 8), {"heads": ("data", "model")}),
                (("embed",), None, {"embed": (("data", "model"),)})]:
            want = ref_shd.spec_for(mesh, logical, shape, rules)
            got = sharding.spec_for(zmesh, logical, shape, rules)
            assert isinstance(want, PartitionSpec)
            assert tuple(got) == tuple(want), (name, logical)


# -- layers ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rmsnorm(dtype):
    ref_cfg, cfg = cfgs("qwen3-0.6b", dtype)
    jp, pp = both(layer0(ref_params(ref_cfg))["ln1"])
    x, xt = rand((3, 1, ref_cfg.d_model), 1, dtype)
    close(L.apply_rmsnorm(pp, xt), ref_L.apply_rmsnorm(jp, x), rtol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope(dtype):
    x, xt = rand((2, 5, 4, 16), 2, dtype)
    pos = np.array([0, 3, 17, 511, 2047])
    close(L.rope(xt, torch.from_numpy(pos), 1e6),
          ref_L.rope(x, jnp.asarray(pos), 1e6), rtol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_mlp(arch, dtype):
    ref_cfg, cfg = cfgs(arch, dtype)
    jp, pp = both(layer0(ref_params(ref_cfg))["ffn"])
    x, xt = rand((3, 1, ref_cfg.d_model), 3, dtype)
    close(L.apply_mlp(pp, xt, cfg), ref_L.apply_mlp(jp, x, ref_cfg),
          rtol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_embed_unembed(arch, dtype):
    ref_cfg, cfg = cfgs(arch, dtype)
    jp, pp = both(ref_params(ref_cfg)["embed"])
    tok = np.array([[0], [7], [ref_cfg.vocab - 1]], np.int32)
    emb = L.apply_embed(pp, torch.from_numpy(tok), cfg)
    want = ref_L.apply_embed(jp, jnp.asarray(tok), ref_cfg)
    assert np.asarray(want).tobytes() == convert._np_leaf(emb).tobytes()
    x, xt = rand((3, 1, ref_cfg.d_model), 4, dtype)
    logits = L.apply_unembed(pp, xt, cfg)
    assert logits.dtype == torch.float32
    close(logits, ref_L.apply_unembed(jp, x, ref_cfg), F32_RTOL
          if dtype == "float32" else BF16_RTOL)


# -- attention ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)   # qk-norm (qwen3), qkv bias (qwen2)
def test_project_q_kv_out(arch, dtype):
    ref_cfg, cfg = cfgs(arch, dtype)
    jp, pp = both(layer0(ref_params(ref_cfg))["attn"])
    assert ("qnorm" in pp) == cfg.qk_norm and ("bq" in pp) == cfg.qkv_bias
    x, xt = rand((3, 1, ref_cfg.d_model), 5, dtype)
    pos = np.array([9])
    close(attention.project_q(pp, xt, cfg, torch.from_numpy(pos)),
          ref_attn.project_q(jp, x, ref_cfg, jnp.asarray(pos)), rtol(dtype))
    for got, want in zip(
            attention.project_kv(pp, xt, cfg, torch.from_numpy(pos)),
            ref_attn.project_kv(jp, x, ref_cfg, jnp.asarray(pos))):
        close(got, want, rtol(dtype))
    a, at = rand((3, 1, ref_cfg.n_heads, ref_cfg.hd), 6, dtype)
    close(attention.apply_out(pp, at, cfg),
          ref_attn.apply_out(jp, a, ref_cfg), rtol(dtype))


def slot_positions(T, pos, window=None):
    """A cache's slot positions after writing positions 0..pos-1 (-1 =
    empty), as a ring under `window`."""
    sp = np.full((T,), -1, np.int32)
    for p in range(pos):
        sp[p % T if window else p] = p
    return sp


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attend_decode(dtype, window):
    B, T, K, g, hd = 3, 16, 2, 2, 16
    q, qt = rand((B, 1, K * g, hd), 7, dtype)
    k, kt = rand((B, T, K, hd), 8, dtype)
    v, vt = rand((B, T, K, hd), 9, dtype)
    for pos in (0, 5, 11):
        sp = slot_positions(T, pos + 1, window)
        close(attention.attend_decode(qt, kt, vt, torch.from_numpy(sp), pos,
                                      window=window),
              ref_attn.attend_decode(q, k, v, jnp.asarray(sp),
                                     jnp.asarray(pos, jnp.int32),
                                     window=window), rtol(dtype))


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cache_update_is_exact_and_builds_new_leaves(dtype, window):
    B, T, K, hd = 2, 8, 2, 4
    k, kt = rand((B, T, K, hd), 10, dtype)
    v, vt = rand((B, T, K, hd), 11, dtype)
    kn, knt = rand((B, 1, K, hd), 12, dtype)
    vn, vnt = rand((B, 1, K, hd), 13, dtype)
    sp = slot_positions(T, 5, window)
    before = [convert._np_leaf(t).copy() for t in (kt, vt)]
    for pos in (5, 7, 13):
        got = attention.cache_update(kt, vt, torch.from_numpy(sp), knt, vnt,
                                     pos, window=window)
        want = ref_attn.cache_update(k, v, jnp.asarray(sp), kn, vn,
                                     jnp.asarray(pos, jnp.int32),
                                     window=window)
        for g_, w_ in zip(got, want):
            assert convert._np_leaf(g_).tobytes() == \
                np.asarray(w_).tobytes()
    for t, b in zip((kt, vt), before):
        assert convert._np_leaf(t).tobytes() == b.tobytes()


# -- blocks and the model -------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_decode(arch, dtype):
    ref_cfg, cfg = cfgs(arch, dtype)
    np_params = ref_params(ref_cfg)
    jp, pp = both(layer0(np_params))
    B, T = 3, 12
    cache = {"k": rand((B, T, cfg.n_kv, cfg.hd), 14, dtype),
             "v": rand((B, T, cfg.n_kv, cfg.hd), 15, dtype)}
    sp = slot_positions(T, 7)
    jc = {n: a for n, (a, _) in cache.items()}
    pc = {n: t for n, (_, t) in cache.items()}
    jc["pos"], pc["pos"] = jnp.asarray(sp), torch.from_numpy(sp.copy())
    x, xt = rand((B, 1, cfg.d_model), 16, dtype)
    mine = {n: t.clone() for n, t in pc.items()}
    at = blocks.decode_positions(7, cfg, xt.device)
    got_x, got_c = blocks.apply_decode(pp, "dense", xt, mine, 7, cfg, at)
    want_x, want_c = ref_blocks.apply_decode(
        jp, "dense", x, jc, jnp.asarray(7, jnp.int32), ref_cfg)
    close(got_x, want_x, rtol(dtype))
    assert convert._np_leaf(got_c["pos"]).tobytes() == \
        np.asarray(want_c["pos"]).tobytes()
    for n in ("k", "v"):
        close(got_c[n], want_c[n], rtol(dtype))
        # the slots already there are untouched copies
        keep = np.asarray(want_c[n])[:, :7]
        assert convert._np_leaf(got_c[n])[:, :7].tobytes() == keep.tobytes()
    # the slot went into the cache it was given, and only there
    for n in ("k", "v", "pos"):
        assert got_c[n] is mine[n]
        assert convert._np_leaf(pc[n]).tobytes() == \
            np.asarray(jc[n]).tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_teacher_forced(arch, dtype):
    """Logits step by step over 10 positions, both packages fed the
    reference's greedy tokens, each carrying its own cache."""
    ref_cfg, cfg = cfgs(arch, dtype)
    np_params = ref_params(ref_cfg)
    jp, pp = both(np_params)
    ref_m, port_m = ref_build(ref_cfg), build_model(cfg)
    step = jax.jit(ref_m.decode_step)
    B, T = 3, 16
    jc = ref_m.init_cache(B, T)
    pc = port_m.init_cache(B, T, device="cpu")
    tok = np.random.default_rng(17).integers(0, cfg.vocab, B).astype(
        np.int32)
    for pos in range(10):
        want, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(pos, jnp.int32))
        before = convert._np_leaf(pc["groups"]["b0_dense"]["k"]).copy()
        got, new_pc = port_m.decode_step(pp, torch.from_numpy(tok), pc, pos)
        assert convert._np_leaf(pc["groups"]["b0_dense"]["k"]).tobytes() \
            == before.tobytes()
        close(got, want, STEP_RTOL[dtype])
        pc = new_pc
        tok = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
    assert convert._np_leaf(pc["groups"]["b0_dense"]["pos"]).tobytes() == \
        np.asarray(jc["groups"]["b0_dense"]["pos"]).tobytes()


@pytest.mark.parametrize("arch", ARCHS)
def test_sv_f32_forward_matches_the_reference(arch):
    """chip_smoke's sv h holds the served decode at full width to an f32
    forward of the whole sequence that takes no cache
    (`chip_smoke.sv_plain_logits`): that forward against the reference's
    decode logits, teacher-forced on its greedy tokens, within F32_RTOL."""
    ref_cfg, cfg = cfgs(arch, "float32")
    np_params = ref_params(ref_cfg)
    jp, pp = both(np_params)
    ref_m = ref_build(ref_cfg)
    step = jax.jit(ref_m.decode_step)
    B, T, S = 3, 24, 20
    jc = ref_m.init_cache(B, T)
    tok = np.random.default_rng(18).integers(0, cfg.vocab, B).astype(
        np.int32)
    seq, want = [], []
    for pos in range(S):
        seq.append(tok)
        logits, jc = step(jp, jnp.asarray(tok), jc,
                          jnp.asarray(pos, jnp.int32))
        want.append(np.asarray(logits))
        tok = np.asarray(jnp.argmax(logits, axis=-1)).astype(np.int32)
    got = chip_smoke.sv_plain_logits(
        cfg, pp, torch.from_numpy(np.stack(seq, 1)))
    close(got, np.stack(want, 1), F32_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_sv_reference_check_at_bf16(arch):
    """sv h on a reduced bf16 model: the port's own greedy tokens pass it
    (their argmax, finite logits, within SV_LOGIT_RTOL of the f32
    forward), and tokens it did not make fail it."""
    _, cfg = cfgs(arch, "bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    cp = model.compute_params(params)
    B, P, N, T = 3, 8, 8, 24
    prompt = torch.from_numpy(np.random.default_rng(19).integers(
        0, cfg.vocab, (B, P)))
    cache, out, tok = model.init_cache(B, T, "cpu"), [], None
    for t in range(P + N - 1):
        logits, cache = model.decode_step(
            cp, prompt[:, t] if t < P else tok, cache, t)
        tok = torch.argmax(logits, dim=-1)
        if t >= P - 1:
            out.append(tok)
    toks = torch.stack(out, 1).numpy().astype(np.int32)
    got = chip_smoke.sv_reference(cfg, params, prompt, toks, T)
    assert got["rel_err"] <= chip_smoke.SV_LOGIT_RTOL
    wrong = toks.copy()
    wrong[0, -1] = (wrong[0, -1] + 1) % cfg.vocab
    with pytest.raises(AssertionError, match="argmax"):
        chip_smoke.sv_reference(cfg, params, prompt, wrong, T)


def test_compute_params_casts_once_to_the_steps_bits():
    """Server.start's cast: every leaf the model casts to bf16, cast once;
    the norm scales kept in f32."""
    ref_cfg, cfg = cfgs("qwen3-0.6b", "bfloat16")
    pp = convert.params_to_port(ref_params(ref_cfg), "cpu")
    cp = build_model(cfg).compute_params(pp)
    g = cp["groups"]["b0_dense"]
    assert g["attn"]["wq"].dtype == torch.bfloat16
    assert cp["embed"]["tok"].dtype == torch.bfloat16
    for leaf in (g["ln1"]["scale"], g["attn"]["qnorm"],
                 cp["final_norm"]["scale"]):
        assert leaf.dtype == torch.float32
    assert torch.equal(g["ffn"]["wi"],
                       pp["groups"]["b0_dense"]["ffn"]["wi"].to(
                           torch.bfloat16))


def test_init_params_from_a_generator():
    """The four init kinds from an explicit generator: the same seed gives
    the same tree; shapes, dtypes and statistics as declared."""
    cfg = registry.get_config("qwen3-0.6b", reduced=True)
    m = build_model(cfg)
    a = m.init(torch.Generator().manual_seed(0), device="cpu")
    b = m.init(torch.Generator().manual_seed(0), device="cpu")
    defs = prm.leaves(m.param_defs())
    for d, x, y in zip(defs, utils.tree_leaves(a), utils.tree_leaves(b)):
        assert tuple(x.shape) == d.shape and torch.equal(x, y)
    assert torch.all(a["final_norm"]["scale"] == 1)
    tok = a["embed"]["tok"]
    assert abs(float(tok.std()) - 0.02) < 0.002
    wi = a["groups"]["b0_dense"]["ffn"]["wi"]
    assert abs(float(wi.std()) - cfg.d_model ** -0.5) < 0.01
    assert prm.count(m.param_defs()) == cfg.param_count()


# -- time-slice footprints ------------------------------------------------------

def _layouts(arch, mesh_name, batch, max_len, bw):
    mesh, zmesh = tr.jax_mesh(mesh_name), tr.zone_mesh(mesh_name)
    ref_m = ref_build(ref_registry.get_config(arch, reduced=True), mesh)
    port_m = build_model(registry.get_config(arch, reduced=True), zmesh)
    specs = ref_m.cache_specs(batch, max_len, mesh)
    abs_ = jax.eval_shape(lambda: ref_m.init_cache(batch, max_len))
    shard = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                         is_leaf=lambda x: isinstance(x, jax.sharding
                                                      .PartitionSpec))
    G = zmesh.group_size
    ref_lo = ref_layout.build_layout(abs_, G, shard, block_words=bw)
    port_lo = layout.build_layout(
        port_m.init_cache(batch, max_len, device="meta"), G,
        port_m.cache_specs(batch, max_len, zmesh), zmesh, block_words=bw)
    return ref_lo, port_lo


def _same_footprints(ref_lo, port_lo, T, positions):
    assert port_lo.row_words == ref_lo.row_words
    assert layout.time_slice_page_capacity(port_lo, T) == \
        ref_layout.time_slice_page_capacity(ref_lo, T)
    for p in positions:
        np.testing.assert_array_equal(
            layout.time_slice_pages(port_lo, T, p),
            ref_layout.time_slice_pages(ref_lo, T, p))
        for g_, w_ in zip(layout.time_slice_words(port_lo, T, p),
                          ref_layout.time_slice_words(ref_lo, T, p),
                          strict=True):
            if w_ is None:
                assert g_ is None
            else:
                np.testing.assert_array_equal(g_, w_)


@pytest.mark.parametrize("bw", [64, 256])
@pytest.mark.parametrize("arch,mesh_name", [("qwen3-0.6b", "mesh42"),
                                            ("qwen2-0.5b", "mesh81")])
def test_time_slice_matches_the_reference(arch, mesh_name, bw):
    """A served cache's footprints at several positions, ring wrap
    included (pos >= max_len)."""
    ref_lo, port_lo = _layouts(arch, mesh_name, 8, 24, bw)
    _same_footprints(ref_lo, port_lo, 24, [0, 1, 7, 13, 23, 24, 31])


def test_time_slice_with_two_candidate_axes():
    """Leaves without sharding: one with two axes of the time size (the
    union of both runs; whole-leaf dirty words), a bf16 one with unaligned
    runs (widened spans), one with no time axis (whole leaf)."""
    T = 6
    shapes = {"a2": ((T, 3, T), jnp.float32, torch.float32),
              "b16": ((5, T, 3), jnp.bfloat16, torch.bfloat16),
              "none": ((7, 5), jnp.float32, torch.float32),
              "pos": ((2, T), jnp.int32, torch.int32)}
    ref_abs = {k: jax.ShapeDtypeStruct(s, jd) for k, (s, jd, _) in
               shapes.items()}
    port_abs = {k: torch.empty(s, dtype=td, device="meta") for k, (s, _, td)
                in shapes.items()}
    for bw in (4, 8):
        ref_lo = ref_layout.build_layout(ref_abs, 2, block_words=bw)
        port_lo = layout.build_layout(port_abs, 2, block_words=bw)
        assert len(layout._slot_time_runs(port_lo.slots[0], T)) == 2
        _same_footprints(ref_lo, port_lo, T, range(2 * T))
    assert layout.time_slice_words(port_lo, 1, 0) == [None] * 4
