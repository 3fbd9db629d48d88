"""The port's xLSTM gradients and blocks against the reference's:
tests/test_torch_xlstm.py's cells through a fixed read-out by autograd
against `jax.grad` (the mLSTM over chunks of 8; the chunk-256 NaN of the
reference against the port's finite gradients), and the mlstm / slstm
blocks' train, decode, cache and logical axes.  The tolerances are that
file's (its docstring).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as ref_blocks
from repro.models import xlstm as ref_xlstm
from repro_torch import utils
from repro_torch.models import blocks, xlstm
from tests import _torch_ref as tr
from tests.test_torch_hybrid import (DTYPES, F32_RTOL, GRAD, both, close,
                                     rand, ref_params, same_grads)
from tests.test_torch_xlstm import (STATE_BF16_RTOL, cfgs, op_by_op, rtol)
from tests._torch_ref import compile_cache, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("compile_cache", "one_thread")


@pytest.fixture(autouse=True)
def _f32_dots(monkeypatch):
    tr.f32_dots(monkeypatch, ref_xlstm)


def grads_against_the_reference(kind, dtype, S, monkeypatch, chunk=None):
    ref_cfg, cfg = cfgs(dtype)
    key = "b0_mlstm" if kind == "mlstm" else "b3_slstm"
    p = jax.tree.map(lambda x: x[0], ref_params(ref_cfg)["groups"][key])[
        "cell"]
    x = np.random.default_rng(8).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    w = np.linspace(-1, 1, cfg.d_model).astype(np.float32)
    ref_apply = getattr(ref_xlstm, f"{kind}_apply_train")
    if chunk is not None:
        monkeypatch.setattr(ref_xlstm, "CHUNK", chunk)

    def f(p, x):
        out = ref_apply(p, x.astype(dtype), ref_cfg)
        return jnp.sum(out.astype(jnp.float32) * w)
    grad = jax.value_and_grad(f, argnums=(0, 1))
    with op_by_op(dtype):
        want, (wgp, wgx) = (grad if dtype == "bfloat16" else jax.jit(grad))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = utils.tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(), p)
    xt = torch.from_numpy(x.copy()).requires_grad_()
    out = getattr(xlstm, f"{kind}_apply_train")(tp, xt.to(
        xlstm.L.cdt(cfg)), cfg)
    got = (out.float() * torch.from_numpy(w)).sum()
    got.backward()
    return (got, want, [t.grad for t in utils.tree_leaves(tp)],
            jax.tree.leaves(wgp), xt.grad, wgx)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_gradients(kind, dtype, monkeypatch):
    """The cell's output through a fixed linear read-out: its value and
    its gradients with respect to every parameter and the input, by
    autograd against `jax.grad` (the mLSTM over chunks of 8)."""
    got, want, gp, wp, gx, wx = grads_against_the_reference(
        kind, dtype, 24, monkeypatch, chunk=8 if kind == "mlstm" else None)
    tol = GRAD[dtype]
    close(got, want, tol["loss"] if dtype == "bfloat16" else F32_RTOL)
    same_grads(gp, wp, tol)
    same_grads([gx], [wx], tol)


def test_chunk_256_gradients_are_finite(monkeypatch):
    """At one chunk of 256 the reference's gradients are NaN: it takes
    exp of the decay matrix before masking its upper triangle, which
    overflows past ~128 positions (0 * inf in the where's gradient).  The
    port masks before the exp: the same forward, and gradients equal to
    the reference's over chunks of 64 (f32)."""
    _, bad, _, wp, _, wx = grads_against_the_reference(
        "mlstm", "float32", 256, monkeypatch)
    assert np.isfinite(float(bad))
    assert not all(np.isfinite(np.asarray(g)).all() for g in wp + [wx])
    monkeypatch.undo()
    got, want, gp, wp, gx, wx = grads_against_the_reference(
        "mlstm", "float32", 256, monkeypatch, chunk=64)
    close(got, want, F32_RTOL)
    same_grads(gp, wp, GRAD["float32"])
    same_grads([gx], [wx], GRAD["float32"])


# -- blocks ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("key", ["b0_mlstm", "b3_slstm"])
def test_block_apply_train_and_decode(key, dtype):
    """The block (x + cell(x)), its cache and logical axes: train over 17
    positions, then one decode step from a random state."""
    ref_cfg, cfg = cfgs(dtype)
    bt = key.split("_", 1)[1]
    jp, pp = both(jax.tree.map(lambda x: x[0],
                               ref_params(ref_cfg)["groups"][key]))
    x, xt = rand((2, 17, cfg.d_model), 9, dtype)
    with op_by_op(dtype):
        want, waux = ref_blocks.apply_train(jp, bt, x, ref_cfg,
                                            positions=jnp.arange(17))
    got, aux = blocks.apply_train(pp, bt, xt, cfg,
                                  positions=torch.arange(17))
    assert aux == waux == {}
    close(got, want, rtol(dtype))
    assert blocks.cache_logical_axes(cfg, bt) == \
        ref_blocks.cache_logical_axes(ref_cfg, bt)
    jc = ref_blocks.init_cache(ref_cfg, bt, 2, 24)
    cache = {n: rand(v.shape, 20 + i, v.dtype, 0.3)
             for i, (n, v) in enumerate(sorted(jc.items()))}
    mine = {n: t.clone() for n, (_, t) in cache.items()}
    x1, xt1 = rand((2, 1, cfg.d_model), 10, dtype)
    with op_by_op(dtype):
        want_x, want_c = ref_blocks.apply_decode(
            jp, bt, x1, {n: a for n, (a, _) in cache.items()},
            jnp.asarray(5, jnp.int32), ref_cfg)
    got_x, got_c = blocks.apply_decode(
        pp, bt, xt1, mine, 5, cfg, blocks.decode_positions(5, cfg, "cpu"))
    close(got_x, want_x, rtol(dtype))
    for n in want_c:
        assert got_c[n] is mine[n]
        tol = (rtol(dtype) if n == "conv"
               else F32_RTOL if dtype == "float32" else STATE_BF16_RTOL)
        close(got_c[n], want_c[n], tol)
