"""Cross-pod gradient compression with error feedback (the reference's
optim/compress.py).

Between pods, the data-center interconnect is the scarcest link.  When
`TrainConfig.grad_compression` is on, the cross-pod combine of the
gradients is explicit and quantized:

    q  = int8(round((g + ef) / scale)),  scale = max|g + ef| / 127
    g' = mean_pods(dequant(q));          ef' = (g + ef) - dequant(q)

Error feedback keeps the quantization bias from accumulating (standard
EF-SGD result); wire traffic across pods drops 2x vs bf16 / 4x vs f32.

The reference runs this in a shard_map: each device quantizes its local
shard of a leaf (its own scale), and a ring over the pod axis passes the
int8 payloads around, each device adding what it receives in ring order.
With the zone mesh on one device (dist/sharding.py), each leaf is cut
into every device's block (`sharding.shard`), the ring is a roll of the
pod dim, and the blocks are put back together (`sharding.unshard`): the
same bits, the dequantized payloads added in the reference's order (own,
then pod p-1, then p-2, ...).  Where a leaf's spec does not name the pod
axis, every pod holds the same block and the value at pod coordinate 0 is
kept, as the reference's shard_map keeps it.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import utils
from repro_torch.dist import sharding as shd

PyTree = Any


def _divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, rounded as a division: by a number or a CPU scalar, PyTorch's
    CUDA kernel multiplies by 1/d, which can land one bit off the
    quotient the reference (and the CPU) gives; a divisor tensor on x's
    device is divided by."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _quantize(x: torch.Tensor, n_lead: int) -> tuple:
    """Each block's int8 payload and f32 scale; a block is one device's,
    the last dims after the `n_lead` mesh dims."""
    xf = x.float()
    amax = xf.abs().reshape(*xf.shape[:n_lead], -1).amax(-1)
    scale = _divide(torch.clamp(amax, min=1e-30), 127.0)
    scale = scale.reshape(*scale.shape, *([1] * (xf.dim() - n_lead)))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _leaf_crosspod_mean(g: torch.Tensor, ef: torch.Tensor, spec, mesh,
                        pod_dim: int) -> tuple:
    """One global leaf: the quantized mean across pods and the new error
    feedback, both global."""
    n_lead = len(mesh.shape)
    n = mesh.shape[pod_dim]
    xf = shd.shard(g, spec, mesh).float() + shd.shard(ef, spec, mesh)
    q, scale = _quantize(xf, n_lead)
    own = _dequantize(q, scale)
    ef_new = xf - own
    acc = own
    for step in range(1, n):
        # after `step` hops of the ring i -> i + 1, pod j holds pod j - step's
        acc = acc + _dequantize(torch.roll(q, step, pod_dim),
                                torch.roll(scale, step, pod_dim))
    out = _divide(acc, float(n)).to(g.dtype)
    return (shd.unshard(out, spec, mesh),
            shd.unshard(ef_new.to(ef.dtype), spec, mesh))


def make_crosspod_compressed_mean(mesh, grad_specs: PyTree,
                                  pod_axis: str = "pod"):
    """Returns f(grads, ef) -> (mean grads, new ef) over global leaves
    placed by `grad_specs` on `mesh`."""
    pod_dim = mesh.axis_names.index(pod_axis)

    def apply(grads, ef):
        leaves, treedef = utils.tree_flatten(grads)
        pairs = [_leaf_crosspod_mean(g, e, s, mesh, pod_dim)
                 for g, e, s in zip(leaves, utils.tree_leaves(ef),
                                    utils.tree_leaves(grad_specs))]
        return (utils.tree_unflatten(treedef, [p[0] for p in pairs]),
                utils.tree_unflatten(treedef, [p[1] for p in pairs]))

    return apply


def init_error_feedback(params: PyTree) -> PyTree:
    """Zero f32 error feedback, one leaf a parameter, on its device."""
    return utils.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
