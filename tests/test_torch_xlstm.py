"""The port's xLSTM modules (repro_torch.models.xlstm: mLSTM's gate
projections, its chunkwise scan, train and decode; sLSTM's cell, train
and decode) against the reference's, on the same numpy inputs at
xlstm-1.3b's `reduced()` width (d_model 64, 4 heads: the mLSTM's
head_dim 32, the sLSTM's 16).  Gradients and the blocks are in
tests/test_torch_xlstm_grads.py, the whole model in
tests/test_torch_ssm_model.py.

Tolerances, as a share of the reference's largest magnitude
(tests/test_torch_hybrid.py's): f32 within F32_RTOL = 1e-5 for every
module, block and state (log_sigmoid, exp and the cumulative sums differ
in the last f32 bits between the packages); bf16 within 2^-7 (a bf16
product summed in another order lands one unit apart), and the f32 state
a bf16 step leaves within 2^-6 (its gates read bf16 q, k, v a unit
apart).  Gradients: f32 within 2e-5 at a cosine of 1 - 1e-9 a leaf, bf16
within 2^-5 at a cosine of 0.999.  Initial states and shapes are exact.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import xlstm as ref_xlstm
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import xlstm
from tests import _torch_ref as tr
from tests.test_torch_hybrid import (BF16_RTOL, DTYPES, F32_RTOL, both, close,
                                     rand, ref_params)
from tests._torch_ref import compile_cache, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("compile_cache", "one_thread")

ARCH = "xlstm-1.3b"
STATE_BF16_RTOL = 2 ** -6
# the scan at chunk 256: within 5e-5 of each output's largest magnitude
# (measured 1.0e-5, on m).  log f's inclusive cumsum runs to ~-80 there,
# XLA (a tree) and torch sum it in other orders, a unit of 2^-17 apart,
# and m = lc_end + max(...) cancels it down to ~0.7
SCAN_256_RTOL = 5e-5


@pytest.fixture(autouse=True)
def _f32_dots(monkeypatch):
    tr.f32_dots(monkeypatch, ref_xlstm)


def cfgs(dtype, **kw):
    ref = dataclasses.replace(ref_registry.get_config(ARCH, reduced=True),
                              compute_dtype=dtype, **kw)
    port = dataclasses.replace(registry.get_config(ARCH, reduced=True),
                               compute_dtype=dtype, **kw)
    return ref, port


def op_by_op(dtype):
    """The context the reference runs in: at bf16 op by op (jitted, XLA
    keeps a chain of bf16 elementwise steps, the conv, in f32 where the
    reference asks for bf16 at each); at f32 jitted."""
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


def jit(fn, cfg):
    """The reference's `fn(*args, cfg)` in `op_by_op`'s context."""
    if cfg.compute_dtype == "float32":
        return jax.jit(lambda *a: fn(*a, cfg))

    def run(*a):
        with jax.disable_jit():
            return fn(*a, cfg)
    return run


def rtol(dtype):
    return F32_RTOL if dtype == "float32" else BF16_RTOL


def cell(ref_cfg, key):
    """Layer 0's cell parameters of block `key`, (jnp tree, port tree)."""
    p = jax.tree.map(lambda x: x[0], ref_params(ref_cfg)["groups"][key])
    return both(p["cell"])


# -- mLSTM ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_qkvif(dtype):
    ref_cfg, cfg = cfgs(dtype)
    jp, pp = cell(ref_cfg, "b0_mlstm")
    x, xt = rand((2, 9, cfg.d_model), 1, dtype)
    want = jit(ref_xlstm._mlstm_qkvif, ref_cfg)(jp, x)
    got = xlstm._mlstm_qkvif(pp, xt, cfg)
    for name, g, w in zip(("q", "k", "v", "i", "f", "z"), got, want):
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype) == f"torch.{w.dtype}", name
        close(g, w, F32_RTOL if name in "if" and dtype == "float32"
              else rtol(dtype) if name not in "if" else BF16_RTOL)


def scan_inputs(S, seed, H=4, dh=8, B=2):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, dh)).astype(np.float32)
               for _ in range(3))
    il = (0.5 * rng.standard_normal((B, S, H))).astype(np.float32)
    fl = (1.0 + rng.standard_normal((B, S, H))).astype(np.float32)
    C = (0.1 * rng.standard_normal((B, H, dh, dh))).astype(np.float32)
    n = (0.1 * rng.standard_normal((B, H, dh))).astype(np.float32)
    m = rng.standard_normal((B, H)).astype(np.float32)
    return (q, k, v, il, fl), (C, n, m)


@pytest.mark.parametrize("S,c", [(12, 1), (12, 3), (256, 256), (9, 3),
                                 (7, 7)])
@pytest.mark.parametrize("fresh", [True, False])
def test_chunk_scan(S, c, fresh):
    """The chunkwise scan at chunk lengths 1, 3, 7 and 256 from a carried
    state and from the init's (m = -1e30): outputs and final state,
    elementwise within rtol 1e-5 / atol 1e-6 (at 256, SCAN_256_RTOL)."""
    seqs, state = scan_inputs(S, S + c)
    if fresh:
        B, _, H, dh = seqs[0].shape
        state = (np.zeros((B, H, dh, dh), np.float32),
                 np.zeros((B, H, dh), np.float32),
                 np.full((B, H), -1e30, np.float32))

    def chunks(t):
        return t.reshape(t.shape[0], S // c, c, *t.shape[2:])
    want, wst = ref_xlstm._mlstm_chunk_scan(
        *(jnp.asarray(chunks(t)) for t in seqs),
        tuple(jnp.asarray(t) for t in state))
    got, gst = xlstm._mlstm_chunk_scan(
        *(torch.from_numpy(chunks(t)) for t in seqs),
        tuple(torch.from_numpy(t) for t in state))
    for g, w in zip((got,) + tuple(gst), (want,) + tuple(wst)):
        if c == 256:
            close(g, w, SCAN_256_RTOL)
        else:
            tr.allclose(g, w)


@pytest.mark.parametrize("S,c", [(1, 1), (7, 7), (256, 256), (257, 1),
                                 (300, 150), (512, 256), (4096, 256)])
def test_chunk_len(S, c):
    """min(256, S) shrunk until it divides S: a prime S past 256 gives 1."""
    assert xlstm.chunk_len(S) == c


def test_mlstm_train_at_a_prime_length():
    """S = 257 runs 257 chunks of one position."""
    ref_cfg, cfg = cfgs("float32")
    jp, pp = cell(ref_cfg, "b1_mlstm")
    x, xt = rand((1, 257, cfg.d_model), 2)
    close(xlstm.mlstm_apply_train(pp, xt, cfg),
          jit(ref_xlstm.mlstm_apply_train, ref_cfg)(jp, x), F32_RTOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [1, 40])
def test_mlstm_train(dtype, S):
    ref_cfg, cfg = cfgs(dtype)
    jp, pp = cell(ref_cfg, "b0_mlstm")
    x, xt = rand((2, S, cfg.d_model), 3, dtype)
    got = xlstm.mlstm_apply_train(pp, xt, cfg)
    assert got.dtype == xt.dtype
    close(got, jit(ref_xlstm.mlstm_apply_train, ref_cfg)(jp, x),
          rtol(dtype))


def test_mlstm_chunk_lengths_agree(monkeypatch):
    """The port's train at chunks of 4 equals the reference's at one
    chunk of 40: the chunk algebra carries the state exactly (in f32)."""
    ref_cfg, cfg = cfgs("float32")
    jp, pp = cell(ref_cfg, "b2_mlstm")
    x, xt = rand((2, 40, cfg.d_model), 4)
    monkeypatch.setattr(xlstm, "CHUNK", 4)
    close(xlstm.mlstm_apply_train(pp, xt, cfg),
          ref_xlstm.mlstm_apply_train(jp, x, ref_cfg), F32_RTOL)


def test_init_states_are_the_references():
    for dtype in DTYPES:
        ref_cfg, cfg = cfgs(dtype)
        for want, got in ((ref_xlstm.mlstm_init_state(ref_cfg, 3),
                           xlstm.mlstm_init_state(cfg, 3, "cpu")),
                          (ref_xlstm.slstm_init_state(ref_cfg, 3),
                           xlstm.slstm_init_state(cfg, 3, "cpu"))):
            assert sorted(got) == sorted(want)
            for n in want:
                assert str(got[n].dtype) == f"torch.{want[n].dtype}"
                assert convert._np_leaf(got[n]).tobytes() == \
                    np.asarray(want[n]).tobytes(), n


def step_all(apply, pp, xt, cache, cfg, S):
    outs = []
    for t in range(S):
        mine = {n: v.clone() for n, v in cache.items()}
        o, cache = apply(pp, xt[:, t:t + 1], mine, cfg)
        assert all(cache[n] is mine[n] for n in cache)
        outs.append(o)
    return torch.cat(outs, 1), cache


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_against_the_reference(kind, dtype):
    """Six O(1) steps from the empty state: the outputs and every state
    leaf (m exactly where it is still the init's)."""
    ref_cfg, cfg = cfgs(dtype)
    key = "b0_mlstm" if kind == "mlstm" else "b3_slstm"
    jp, pp = cell(ref_cfg, key)
    ref_step = getattr(ref_xlstm, f"{kind}_apply_decode")
    jc = getattr(ref_xlstm, f"{kind}_init_state")(ref_cfg, 3)
    pc = getattr(xlstm, f"{kind}_init_state")(cfg, 3, "cpu")
    x, xt = rand((3, 6, cfg.d_model), 5, dtype)
    wants = []
    for t in range(6):
        w, jc = jit(ref_step, ref_cfg)(jp, x[:, t:t + 1], jc)
        wants.append(w)
    got, pc = step_all(getattr(xlstm, f"{kind}_apply_decode"), pp, xt, pc,
                       cfg, 6)
    close(got, jnp.concatenate(wants, 1), rtol(dtype))
    for n in jc:
        tol = (rtol(dtype) if n == "conv"
               else F32_RTOL if dtype == "float32" else STATE_BF16_RTOL)
        close(pc[n], jc[n], tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_train(dtype):
    ref_cfg, cfg = cfgs(dtype)
    jp, pp = cell(ref_cfg, "b3_slstm")
    x, xt = rand((2, 33, cfg.d_model), 6, dtype)
    got = xlstm.slstm_apply_train(pp, xt, cfg)
    assert got.dtype == xt.dtype
    close(got, jit(ref_xlstm.slstm_apply_train, ref_cfg)(jp, x),
          rtol(dtype))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_matches_train(kind):
    """The reference's `test_decode_matches_forward` property on a cell:
    the decode stepped over S equals the full-sequence train (f32)."""
    _, cfg = cfgs("float32")
    ref_cfg, _ = cfgs("float32")
    _, pp = cell(ref_cfg, "b1_mlstm" if kind == "mlstm" else "b3_slstm")
    _, xt = rand((2, 21, cfg.d_model), 7)
    with torch.no_grad():
        full = getattr(xlstm, f"{kind}_apply_train")(pp, xt, cfg)
        stepped, _ = step_all(getattr(xlstm, f"{kind}_apply_decode"), pp,
                              xt, getattr(xlstm, f"{kind}_init_state")(
                                  cfg, 2, "cpu"), cfg, 21)
    rel = float((stepped - full).abs().max() / full.abs().max())
    assert rel < 1e-4, rel
