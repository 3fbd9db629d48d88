"""Zone meshes of the reference's launchers (launch/mesh.py).

Mesh axes:
  single-pod:  (16, 16)        -> ("data", "model")
  multi-pod:   (2, 16, 16)     -> ("pod", "data", "model")

The "data" axis is the Pangolin zone axis (parity groups of G = 16).  A
`ZoneMesh` is virtual: one device holds every zone rank, so any shape
runs on one card (or the CPU).
"""
from __future__ import annotations

from repro_torch.dist.sharding import ZoneMesh


def make_production_mesh(*, multi_pod: bool = False) -> ZoneMesh:
    if multi_pod:
        return ZoneMesh((2, 16, 16), ("pod", "data", "model"))
    return ZoneMesh((16, 16), ("data", "model"))


def make_test_mesh(data: int = 4, model: int = 2, pod: int = 0) -> ZoneMesh:
    if pod:
        return ZoneMesh((pod, data, model), ("pod", "data", "model"))
    return ZoneMesh((data, model), ("data", "model"))


def data_axis_size(mesh: ZoneMesh) -> int:
    return mesh.axis_size("data")
