"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip where no GPU is present.  This file imports
neither JAX nor the reference, so it also runs on a machine that has only
PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels import commit_fused as port_cf
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
def test_cuda_kernels_match_plain(card, lead, n, bw):
    old, new = _pages((*lead, n, bw), 1, card), _pages((*lead, n, bw), 2, card)
    stored = port_fl.fletcher_pages_plain(old)
    stored[..., ::3, 0] ^= 1                   # a few corrupted stored rows
    _build.reset_launches()
    got = [ops.fletcher_blocks(new), ops.fletcher_stream(new),
           ops.fused_commit(old, new), ops.fused_verify_commit(old, new, stored),
           ops.fused_commit_old_terms(old, new),
           ops.fused_verify_commit_stream(old, new, stored)]
    torch.cuda.synchronize()
    zeros = torch.zeros_like(stored)
    want = [(port_fl.fletcher_pages_plain(new),),
            port_fl.fletcher_stream_plain(new),
            port_cf.commit_pages_plain(old, new)[:2],
            port_cf.commit_pages_plain(old, new, stored),
            port_cf.commit_pages_plain(old, new, zeros)[:3],
            port_cf.commit_pages_plain(old, new, stored, digest=True)]
    for name, g, w in zip(ops.ENTRY_POINTS, got, want):
        g = g if isinstance(g, tuple) else (g,)
        w = [x if x is None or i != 2 or name not in (
            "fused_verify_commit", "fused_verify_commit_stream")
             else (x != 0).any(-1) for i, x in enumerate(w)]
        for a, b in zip(g, w):
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
