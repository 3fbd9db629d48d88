"""The port's training attention (`models.attention.attend`, a
`torch.autograd.Function` with the reference's flash backward) against
the reference's `attend` and its custom VJP, on the same numpy inputs.

f32 results are held to F32_RTOL of the largest magnitude of the
reference's (the tiles' sums run in another order); bf16 inputs, whose
p and ds round to bf16 before their products as in the reference, to
BF16_RTOL (two bf16 units of the largest value).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro_torch.models import attention
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

F32_RTOL = 1e-5
BF16_RTOL = 2 ** -7

CASES = [
    # (S, H, K, hd, causal, window, chunk)
    (64, 4, 2, 16, True, None, 16),
    (64, 4, 2, 16, True, 24, 16),
    (64, 4, 2, 16, False, None, 16),
    (48, 4, 4, 8, True, None, 32),       # chunk 32 -> 24, the largest divisor
    (40, 6, 2, 8, True, 7, 8),           # a window shorter than a tile
    (32, 2, 1, 16, True, None, 256),     # one tile
]


def inputs(S, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((2, S, H, hd), (2, S, K, hd), (2, S, K, hd), (2, S, H, hd))]


def close(got, want, rtol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_attend_and_its_gradients_match_the_reference(case, dtype):
    S, H, K, hd, causal, window, chunk = case
    q, k, v, dout = inputs(S, H, K, hd, seed=S + H + hd)
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, dout))

    def f(q, k, v):
        return ref_attn.attend(q, k, v, causal=causal, window=window,
                               chunk=chunk)
    out, vjp = jax.vjp(f, jq, jk, jv)
    grads = vjp(jdo)

    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        tdt).requires_grad_() for a in (jq, jk, jv))
    got = attention.attend(tq, tk, tv, causal=causal, window=window,
                           chunk=chunk)
    assert got.dtype == tdt
    got.backward(torch.from_numpy(np.array(jdo.astype(jnp.float32))).to(
        tdt))
    rtol = F32_RTOL if dtype == "float32" else BF16_RTOL
    close(got, out, rtol)
    for t, want in zip((tq, tk, tv), grads):
        assert t.grad.dtype == tdt
        close(t.grad, want, rtol)


@pytest.mark.parametrize("s,target,want", [(1024, 256, 256), (48, 32, 24),
                                           (7, 256, 7), (97, 16, 1)])
def test_pick_chunk_is_the_references(s, target, want):
    assert attention._pick_chunk(s, target) == want == \
        ref_attn._pick_chunk(s, target)


def test_tile_masks_match_the_reference():
    for causal in (True, False):
        for window in (None, 5, 40):
            for qp, kp in ((0, 0), (16, 0), (0, 16), (32, 8), (64, 0)):
                want = np.asarray(ref_attn._tile_mask(causal, window, qp, kp,
                                                      16, 16))
                got = attention._tile_mask(causal, window, qp, kp, 16, 16,
                                           "cpu")
                got = np.ones((16, 16), bool) if got is None else got.numpy()
                assert (got == want).all(), (causal, window, qp, kp)
                assert attention._tile_live(causal, window, qp, kp, 16,
                                            16) == bool(want.any())


def test_no_quadratic_residuals():
    """The autograd graph keeps (q, k, v, out, lse) and no score tile: no
    saved tensor holds S^2 elements a head (the reference's
    tests/test_attention_vjp.py::test_no_quadratic_residuals)."""
    B, S, H, K, hd = 1, 256, 4, 2, 16
    q, k, v, _ = inputs(S, H, K, hd, seed=1)
    tq, tk, tv = (torch.from_numpy(a[:B]).requires_grad_()
                  for a in (q, k, v))
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = attention.attend(tq, tk, tv, causal=True, chunk=32)
    assert saved and max(saved) < S * S, saved
    assert max(saved) <= B * S * H * hd
    out.sum().backward()
    assert tq.grad is not None and tk.grad is not None


def test_backward_recomputes_only_live_tiles():
    """A causal pass visits the nq (nq + 1) / 2 tiles on and below the
    diagonal, forward and backward alike."""
    S, H, K, hd, c = 128, 2, 1, 8, 32
    q, k, v, _ = inputs(S, H, K, hd, seed=2)
    calls = []
    real = torch.matmul

    def counted(a, b):
        calls.append(a.shape[-2:] + b.shape[-2:])
        return real(a, b)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    torch.matmul = counted
    try:
        out = attention.attend(tq, tk, tv, causal=True, chunk=c)
        fwd = len(calls)
        out.sum().backward()
    finally:
        torch.matmul = real
    tiles = (S // c) * (S // c + 1) // 2
    assert fwd == 2 * tiles                      # q·k and p·v a tile
    assert len(calls) - fwd == 5 * tiles         # s, dp, dq, dk, dv a tile
