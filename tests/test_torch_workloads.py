"""The dry run's input surfaces against the reference's: `WORKLOADS` and
`workload_skips` for every architecture; `batch_abstract`,
`decode_abstract` and `decode_specs` at the published configs on the
16 x 16 production mesh; the Protector's `abstract_protected`,
`protected_specs` and `parity_sharding` on a reduced config over (4, 2)
and the published qwen3-0.6b on 16 x 16.

All of it is abstract: the port's tensors are `device="meta"` (they hold
no bytes) and the reference's ShapeDtypeStructs.  The reference's 16 x 16
mesh is an AbstractMesh (the test process has eight devices), its
`devices` hidden so that the reference's `spec_for` takes the mesh's
shape.  The port keeps u32 words as int32 bits and a ProtectedState's
leaves zone-stacked, `(*mesh_dims, *local shape)`; the reference's are
uint32 and global.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

from repro.configs import WORKLOADS as REF_WORKLOADS
from repro.configs import workload_skips as ref_skips
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.configs.registry import get_config as ref_config
from repro.core.txn import Protector as RefProtector
from repro.models import api as ref_api
from repro.models.transformer import build_model as ref_build
from repro.optim import build_optimizer as ref_optimizer
from repro_torch import utils
from repro_torch.configs import (WORKLOADS, TrainConfig, Workload,
                                 get_config, list_archs, workload_skips)
from repro_torch.core.txn import Protector
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.models.transformer import build_model
from repro_torch.optim import build_optimizer
from tests import _torch_ref as tr
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = list_archs()


class _Abstract(AbstractMesh):
    """An AbstractMesh whose missing `devices` reads as absent."""

    @property
    def devices(self):
        raise AttributeError("devices")


def ref_production_mesh():
    return _Abstract((16, 16), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def same_leaf(port: torch.Tensor, ref, zone=None, spec=None):
    """A meta tensor against a ShapeDtypeStruct: shape and dtype (u32 as
    int32 bits); `zone` a ZoneMesh when the port's leaf is zone-stacked
    by `spec`."""
    assert port.is_meta
    want = tuple(ref.shape)
    if zone is not None:
        want = tuple(zone.shape) + shd.local_shape(want, spec, zone)
    assert tuple(port.shape) == want
    name = dtype_name(ref.dtype)
    assert dtype_name(port.dtype) == ("int32" if name == "uint32" else name)


def same_spec(port, ref):
    assert tuple(port) == tuple(ref), (port, ref)


def test_workloads_are_the_references():
    assert list(WORKLOADS) == list(REF_WORKLOADS)
    for name, wl in WORKLOADS.items():
        ref = REF_WORKLOADS[name]
        assert isinstance(wl, Workload)
        assert (wl.name, wl.kind, wl.seq_len, wl.global_batch,
                wl.is_decode) == (ref.name, ref.kind, ref.seq_len,
                                  ref.global_batch, ref.is_decode)


@pytest.mark.parametrize("arch", ARCHS)
def test_workload_skips_are_the_references(arch):
    for reduced in (False, True):
        cfg, rcfg = get_config(arch, reduced), ref_config(arch, reduced)
        for name in WORKLOADS:
            assert workload_skips(cfg, WORKLOADS[name]) == ref_skips(
                rcfg, REF_WORKLOADS[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_inputs_at_the_published_config(arch):
    """Every unskipped workload of every architecture at full size:
    the batch, or the decode token, cache and position, shape for shape
    and spec for spec; no bytes held."""
    mesh, rmesh = make_production_mesh(), ref_production_mesh()
    cfg, rcfg = get_config(arch), ref_config(arch)
    model, rmodel = build_model(cfg, mesh), ref_build(rcfg, rmesh)
    for name, wl in WORKLOADS.items():
        rwl = REF_WORKLOADS[name]
        if workload_skips(cfg, wl):
            continue
        if wl.kind != "decode":
            got, want = api.batch_abstract(cfg, wl), ref_api.batch_abstract(
                rcfg, rwl)
            assert sorted(got) == sorted(want)
            for k in got:
                same_leaf(got[k], want[k])
            continue
        got = api.decode_abstract(cfg, wl, model)
        want = ref_api.decode_abstract(rcfg, rwl, rmodel)
        same_leaf(got["token"], want["token"])
        same_leaf(got["pos"], want["pos"])
        leaves = utils.tree_leaves(got["cache"])
        rleaves = jax.tree.leaves(want["cache"])
        assert len(leaves) == len(rleaves)
        for a, b in zip(leaves, rleaves):
            same_leaf(a, b)
        specs = api.decode_specs(cfg, wl, model, mesh)
        rspecs = ref_api.decode_specs(rcfg, rwl, rmodel, rmesh)
        same_spec(specs["token"], rspecs["token"])
        same_spec(specs["pos"], rspecs["pos"])
        rcache = jax.tree.leaves(rspecs["cache"],
                                 is_leaf=lambda x: isinstance(
                                     x, jax.sharding.PartitionSpec))
        pcache = utils.tree_leaves(specs["cache"])
        assert len(pcache) == len(rcache)
        for a, b in zip(pcache, rcache):
            same_spec(a, b)


def protectors(arch, reduced, mesh, rmesh, **kw):
    cfg, rcfg = get_config(arch, reduced), ref_config(arch, reduced)
    model, rmodel = build_model(cfg, mesh), ref_build(rcfg, rmesh)
    opt = build_optimizer(TrainConfig(), cfg)
    ropt = ref_optimizer(RefTrainConfig(), rcfg)
    state = api.abstract_train_state(model, opt)
    specs = api.train_state_specs(model, opt, mesh)
    rstate = ref_api.abstract_train_state(rmodel, ropt)
    rspecs = ref_api.train_state_specs(rmodel, ropt, rmesh)
    return (Protector(mesh, state, specs, **kw), state,
            RefProtector(rmesh, rstate, rspecs, **kw), rstate)


def same_protected(port, pstate, ref, rstate, mesh):
    got, want = port.abstract_protected(pstate), ref.abstract_protected(
        rstate)
    specs = utils.tree_leaves(port.state_specs)
    for a, b, s in zip(utils.tree_leaves(got.state),
                       jax.tree.leaves(want.state), specs, strict=True):
        same_leaf(a, b, mesh, s)
    for k in ("synd", "cksums", "digest", "row"):
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None), k
        if a is not None:
            same_leaf(a, b)
    same_leaf(got.step, want.step)
    assert (got.replica is None) == (want.replica is None)
    if got.replica is not None:
        for a, b, s in zip(utils.tree_leaves(got.replica),
                           jax.tree.leaves(want.replica), specs, strict=True):
            same_leaf(a, b, mesh, s)
    assert (got.log is None) == (want.log is None)
    if got.log is not None:
        for k in ("step", "data_cursor", "rng", "digest", "mark"):
            same_leaf(getattr(got.log, k), getattr(want.log, k))
    pspecs, rspecs = port.protected_specs(), ref.protected_specs()
    for k in ("synd", "cksums", "digest", "row", "step"):
        a, b = getattr(pspecs, k), getattr(rspecs, k)
        assert (a is None) == (b is None), k
        if a is not None:
            same_spec(a, b)
    is_spec = (lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for a, b in zip(utils.tree_leaves(pspecs.state),
                    jax.tree.leaves(rspecs.state, is_leaf=is_spec),
                    strict=True):
        same_spec(a, b)
    if pspecs.log is not None:
        for k in ("step", "data_cursor", "rng", "digest", "mark"):
            same_spec(getattr(pspecs.log, k), getattr(rspecs.log, k))
    zmesh, zspec = port.parity_sharding()
    ref_sh = ref.parity_sharding()
    assert zmesh is port.mesh
    assert tuple(zmesh.axis_names) == tuple(ref_sh.mesh.axis_names)
    same_spec(zspec, ref_sh.spec)


@pytest.mark.parametrize("kw", [
    dict(mode="mlpc"), dict(mode="mlpc", redundancy=3), dict(mode="mlp"),
    dict(mode="ml"), dict(mode="replica"), dict(mode="none")],
    ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_abstract_protected_on_a_reduced_config(kw):
    mesh, rmesh = tr.zone_mesh("mesh42"), tr.jax_mesh("mesh42")
    port, pstate, ref, rstate = protectors("qwen3-0.6b", True, mesh, rmesh,
                                           block_words=64, **kw)
    same_protected(port, pstate, ref, rstate, mesh)


def test_abstract_protected_at_the_published_config():
    """qwen3-0.6b's train state on the 16 x 16 mesh: a 7.15 GB state and
    its protection, zone-stacked on meta with no bytes held."""
    mesh, rmesh = make_production_mesh(), ref_production_mesh()
    port, pstate, ref, rstate = protectors("qwen3-0.6b", False, mesh, rmesh)
    same_protected(port, pstate, ref, rstate, mesh)
    got = port.abstract_protected(pstate)
    assert all(t.is_meta for t in utils.tree_leaves(got.state))
    assert got.row.shape == (16, 16, port.layout.row_words)
    assert np.prod(got.row.shape) * 4 > 10 ** 9
