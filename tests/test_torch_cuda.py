"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip where no GPU is present.  This file imports
neither JAX nor the reference (only the port and chip_smoke.py's kernel
calls), so it also runs on a machine that has only PyTorch and the CUDA
toolkit; run it from the repo root:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.kernels import _build, ops
from repro_torch.kernels import fletcher as port_fl


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels build with nvcc "
                    "and run only on the card")
    return torch.device("cuda")


def _pages(shape, seed, device):
    bits = np.random.default_rng(seed).integers(0, 2**32, size=shape,
                                                dtype=np.uint32)
    return torch.from_numpy(bits.view(np.int32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("lead,n,bw", [((), 1, 64), ((), 13, 64),
                                       ((3,), 13, 1024), ((2, 2), 300, 1024)])
@pytest.mark.parametrize("r", [2, 3, 4])
def test_cuda_kernels_match_plain(card, lead, n, bw, r):
    """Every entry point's kernel (all 19) against its plain version (the
    calls of chip_smoke.entry_calls), the syndrome sweeps at r; one launch
    each."""
    old, new = _pages((*lead, n, bw), 1, card), _pages((*lead, n, bw), 2, card)
    stored = port_fl.fletcher_pages_plain(old)
    stored[..., ::3, 0] ^= 1                   # a few corrupted stored rows
    coeffs = chip_smoke.coeff_table(lead, r, card)
    calls = chip_smoke.entry_calls(old, new, stored, coeffs, new)
    assert set(calls) == set(ops.ENTRY_POINTS)
    _build.reset_launches()
    got = {name: kernel() for name, (kernel, _) in calls.items()}
    torch.cuda.synchronize()
    for name, (_, plain) in calls.items():
        want = plain()
        assert len(got[name]) == len(want), name
        for a, b in zip(got[name], want):
            assert torch.equal(a, b), name
    assert _build.LAUNCHES == {k: 1 for k in ops.ENTRY_POINTS}


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_they_cannot_launch(card):
    x = torch.zeros(4, 66, dtype=torch.int32, device=card)      # bw % 4 != 0
    with pytest.raises(ValueError, match="bw % 4"):
        ops.fletcher_blocks(x)
    with pytest.raises(ValueError, match="int32"):
        ops.fletcher_blocks(torch.zeros(4, 64, device=card))
    y = torch.zeros(4, 128, dtype=torch.int32, device=card)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_commit(y, y)
    z = torch.zeros(4, 64, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="coefficients"):
        ops.fused_commit_s(z, z, torch.ones(4, 5, dtype=torch.int32,
                                            device=card))      # r = 5
    with pytest.raises(ValueError, match="coefficients"):
        ops.syndrome_scale(z, torch.ones(3, 2, dtype=torch.int32,
                                         device=card))
    with pytest.raises(ValueError, match="m % 4"):
        ops.gf_scale(torch.zeros(6, dtype=torch.int32, device=card), 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_accum_commit(y, y, y)
    with pytest.raises(ValueError, match="must match"):
        ops.fused_accum_commit_stream(torch.zeros(3, 64, dtype=torch.int32,
                                                  device=card), z, z)
    with pytest.raises(ValueError, match="contiguous"):
        ops.xor_delta(y, y)
    with pytest.raises(ValueError, match="one shape"):
        ops.xor_accum(z, x)


@pytest.mark.cuda
@pytest.mark.parametrize("n,off_a,off_b", [(1001, 0, 0), (7, 0, 0),
                                           (4096, 1, 2), (8194, 1, 0),
                                           (0, 0, 0)])
def test_cuda_xor_takes_any_length_and_alignment(card, n, off_a, off_b):
    """The XOR kernel on 1-D runs whose length is not a multiple of 4 (its
    scalar tail) and slices off a 16-byte boundary (its scalar path)."""
    a = _pages((n + 3,), 3, card)[off_a:off_a + n]
    b = _pages((n + 3,), 4, card)[off_b:off_b + n]
    for fn in (ops.xor_delta, ops.xor_accum):
        got = fn(a, b)
        torch.cuda.synchronize()
        assert torch.equal(got, a ^ b)


@pytest.mark.cuda
@pytest.mark.parametrize("r,lead,m", chip_smoke.weight_edge_cases())
def test_cuda_weight_words_edges(card, r, lead, m):
    """weight_words (gf_scale at r = 1, sdelta_stack at r = 2..4) against
    its plain version: leads 1, 3 and 100; rows of one uint4, of 1020
    words, of a block's share ± 4 words and of a main-path rank; a
    coefficient table holding 0 and 1 (gf_scale: by 0, 1 and a rank
    coefficient)."""
    gen = np.random.default_rng(r * 1000 + lead + m)

    def pages(shape):
        bits = gen.integers(0, 2**32, size=shape, dtype=np.uint32)
        return torch.from_numpy(bits.view(np.int32)).to(card)
    _build.reset_launches()
    cases = chip_smoke.weight_case(pages, card, r, lead, m)
    for kernel, plain in cases:
        got = kernel()
        torch.cuda.synchronize()
        assert torch.equal(got, plain())
    name = "gf_scale" if r == 1 else "sdelta_stack"
    assert _build.LAUNCHES == {name: len(cases)}


@pytest.mark.cuda
@pytest.mark.parametrize("r,lead,n,bw", chip_smoke.run_edge_cases())
def test_cuda_page_run_edges(card, r, lead, n, bw):
    """The page-run sweeps against their plain versions: the five
    syndrome_pages entry points at r = 2..4 (a coefficient table holding 0
    and 1) and, at r = 2, both fletcher_pages entry points; leads 1, 3 and
    100 of n pages around the K pages a CTA takes (1, K - 1, K, K + 1), 16
    and 2600; pages of 4 and 1024 words."""
    gen = np.random.default_rng(r * 1_000_003 + lead * 10_007 + n * 11 + bw)

    def pages(shape):
        bits = gen.integers(0, 2**32, size=shape, dtype=np.uint32)
        return torch.from_numpy(bits.view(np.int32)).to(card)
    _build.reset_launches()
    cases = chip_smoke.run_case(pages, card, r, lead, n, bw)
    for name, kernel, plain in cases:
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        assert len(got) == len(want), name
        for a, b in zip(got, want):
            assert torch.equal(a, b), name
    assert _build.LAUNCHES == {name: 1 for name, *_ in cases}
