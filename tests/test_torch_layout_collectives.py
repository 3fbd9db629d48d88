"""Zone layout, zone-stacked sharding and the r = 1 parity algebra of the
port against the reference on the conftest meshes (mesh42, mesh81,
mesh_pod): the layout, every rank's row, and build / patch / reconstruct
against the reference's shard_map'd functions — byte-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from repro.compat import shard_map
from repro.core import layout as ref_layout
from repro.core import parity as ref_parity
from repro.core.txn import Mode, Protector
from repro_torch.core import layout, parity
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding
from tests._torch_ref import (MESHES, as_words, jax_mesh, jax_specs,
                              port_specs, rand_u32, small_state_np, to_jax,
                              to_torch, words, zone_mesh)
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

MESH_NAMES = list(MESHES)


def _bits(t):
    return t.reshape(-1).view(torch.uint8)


def _zone_fn(mesh, f, n_in, extra_specs=()):
    """shard_map `f` over the zone: every operand and output zone-stacked."""
    z = PartitionSpec(*mesh.axis_names)
    n = len(mesh.axis_names)

    def body(*args):
        local = [a.reshape(a.shape[n:]) for a in args[:n_in]]
        out = f(*local, *args[n_in:])
        return out.reshape((1,) * n + out.shape)

    return jax.jit(shard_map(body, mesh=mesh, in_specs=(z,) * n_in +
                             tuple(extra_specs), out_specs=z,
                             check_vma=False))


@pytest.mark.parametrize("name", MESH_NAMES)
def test_layout_and_rows_match_reference(name):
    mesh, zmesh = jax_mesh(name), zone_mesh(name)
    state_np, specs = small_state_np()
    ref_state = to_jax(state_np, specs, mesh)
    p = Protector(mesh, jax.eval_shape(lambda: ref_state), jax_specs(specs),
                  mode=Mode.MLPC, block_words=64)
    lo = layout.build_layout(to_torch(state_np), zmesh.group_size,
                             port_specs(specs), zmesh, block_words=64)
    ref_lo = p.layout
    assert (lo.row_words, lo.n_blocks, lo.seg_words, lo.payload_words) == (
        ref_lo.row_words, ref_lo.n_blocks, ref_lo.seg_words,
        ref_lo.payload_words)
    for a, b in zip(lo.slots, ref_lo.slots):
        assert (a.offset, a.n_words, a.shape) == (b.offset, b.n_words,
                                                  b.shape)
    assert lo.overhead_report() == ref_lo.overhead_report()
    stacked = {k: sharding.shard(v, port_specs(specs)[k], zmesh)
               for k, v in to_torch(state_np).items()}
    row = layout.flatten_row(lo, stacked)
    np.testing.assert_array_equal(words(row), np.asarray(p.init(ref_state).row))
    back = layout.unflatten_row(lo, row)
    for k, v in stacked.items():
        assert torch.equal(_bits(back[k]), _bits(v))
        glob = sharding.unshard(v, port_specs(specs)[k], zmesh)
        assert glob.shape == to_torch(state_np)[k].shape
        assert torch.equal(_bits(glob), _bits(to_torch(state_np)[k]))


def test_page_helpers_match_reference():
    mesh, zmesh = jax_mesh("mesh42"), zone_mesh("mesh42")
    state_np, specs = small_state_np()
    ref_lo = Protector(mesh, jax.eval_shape(
        lambda: to_jax(state_np, specs, mesh)), jax_specs(specs),
        block_words=64).layout
    lo = layout.build_layout(to_torch(state_np), 4, port_specs(specs), zmesh,
                             block_words=64)
    for pages in ([0], [1, 3], [2]):
        assert layout.leaves_for_pages(lo, pages) == \
            ref_layout.leaves_for_pages(ref_lo, pages)
    for i in range(len(lo.slots)):
        np.testing.assert_array_equal(layout.leaf_pages(lo, i),
                                      ref_layout.leaf_pages(ref_lo, i))
    np.testing.assert_array_equal(layout.range_pages(lo, 70, 100),
                                  ref_layout.range_pages(ref_lo, 70, 100))


@pytest.mark.parametrize("name", MESH_NAMES)
def test_parity_build_patch_reconstruct_match_reference(name):
    mesh, zmesh = jax_mesh(name), zone_mesh(name)
    dd, g = zmesh.data_dim, zmesh.group_size
    state_np, specs = small_state_np()
    lo = layout.build_layout(to_torch(state_np), g, port_specs(specs), zmesh,
                             block_words=64)
    ref_lo = Protector(mesh, jax.eval_shape(
        lambda: to_jax(state_np, specs, mesh)), jax_specs(specs),
        block_words=64).layout
    z = NamedSharding(mesh, PartitionSpec(*mesh.axis_names))
    rows = rand_u32(zmesh.shape + (lo.row_words,), seed=dd)
    jrows = jax.device_put(rows, z)

    synd = parity.build_syndromes(as_words(rows), dd)
    ref_synd = _zone_fn(mesh, lambda r: ref_parity.build_syndromes(
        r, 1, "data"), 1)(jrows)
    np.testing.assert_array_equal(words(synd), np.asarray(ref_synd))

    k = 3
    idx = np.array([0, 2, 3], np.int32)
    sdelta = rand_u32(zmesh.shape + (1, k, 64), seed=5)
    got = parity.patch_syndrome_delta(synd, as_words(sdelta),
                                      torch.from_numpy(idx), lo, dd)
    want = _zone_fn(mesh, lambda s, d, i: ref_parity.patch_syndrome_delta(
        s, d, i, ref_lo, "data"), 2, (PartitionSpec(),))(
        ref_synd, jax.device_put(sdelta, z), jnp.asarray(idx))
    np.testing.assert_array_equal(words(got), np.asarray(want))

    for lost in (0, g - 1):
        got = parity.reconstruct_row(as_words(rows), synd[..., 0, :], lost, dd)
        want = _zone_fn(mesh, lambda r, s: ref_parity.reconstruct_row(
            r, s[0], lost, "data"), 2)(jrows, ref_synd)
        np.testing.assert_array_equal(words(got), np.asarray(want))
        # the rebuilt row is the lost rank's own row in every zone
        np.testing.assert_array_equal(
            words(got.select(dd, 0)), np.take(rows, lost, axis=dd))

    ok = parity.verify_syndromes(as_words(rows), synd, dd)
    assert ok.all() and ok.shape == tuple(
        s for i, s in enumerate(zmesh.shape) if i != dd) + (1,)


@pytest.mark.parametrize("name", MESH_NAMES)
def test_legacy_parity_and_meta_collectives_match_reference(name):
    """The single-parity forms (patch_parity through the xor_delta kernel,
    hybrid_update on each branch, verify_parity), a stack patch whose
    index list carries repeated out-of-range sentinels, and the window
    metadata collectives (meta_all_gather, xor_tree_reduce)."""
    from repro.dist import collectives as ref_coll
    mesh, zmesh = jax_mesh(name), zone_mesh(name)
    dd, g, n_axes = zmesh.data_dim, zmesh.group_size, len(zmesh.shape)
    state_np, specs = small_state_np()
    lo = layout.build_layout(to_torch(state_np), g, port_specs(specs), zmesh,
                             block_words=64)
    ref_lo = Protector(mesh, jax.eval_shape(
        lambda: to_jax(state_np, specs, mesh)), jax_specs(specs),
        block_words=64).layout
    z = NamedSharding(mesh, PartitionSpec(*mesh.axis_names))
    rows = rand_u32(zmesh.shape + (lo.row_words,), seed=11)
    new_rows = rand_u32(zmesh.shape + (lo.row_words,), seed=12)
    jrows, jnew = jax.device_put(rows, z), jax.device_put(new_rows, z)
    par = coll.xor_reduce_scatter(as_words(rows), dd)
    jpar = jax.device_put(words(par), z)
    nb = lo.n_blocks

    idx = np.array([0, nb - 1], np.int32)
    old_p = parity.gather_pages(as_words(rows), torch.from_numpy(idx), 64)
    new_p = parity.gather_pages(as_words(new_rows), torch.from_numpy(idx), 64)
    got = parity.patch_parity(par, old_p, new_p, torch.from_numpy(idx), lo,
                              dd)
    want = _zone_fn(mesh, lambda s, o, n, i: ref_parity.patch_parity(
        s, o, n, i, ref_lo, "data"), 3, (PartitionSpec(),))(
        jpar, jax.device_put(words(old_p), z),
        jax.device_put(words(new_p), z), jnp.asarray(idx))
    np.testing.assert_array_equal(words(got), np.asarray(want))

    sidx = np.array([nb - 1, nb, 1, nb], np.int32)     # two sentinels
    sdelta = rand_u32(zmesh.shape + (2, 4, 64), seed=13)
    stack = torch.stack([par, par ^ 5], dim=-2)
    got = parity.patch_syndrome_delta(stack, as_words(sdelta),
                                      torch.from_numpy(sidx), lo, dd)
    want = _zone_fn(mesh, lambda s, d, i: ref_parity.patch_syndrome_delta(
        s, d, i, ref_lo, "data"), 2, (PartitionSpec(),))(
        jax.device_put(words(stack), z), jax.device_put(sdelta, z),
        jnp.asarray(sidx))
    np.testing.assert_array_equal(words(got), np.asarray(want))

    for dirty in (None, [], [1], list(range(nb))):
        got = parity.hybrid_update(as_words(rows), as_words(new_rows), par,
                                   lo, dd, dirty)
        want = _zone_fn(mesh, lambda r, n, s: ref_parity.hybrid_update(
            r, n, s, ref_lo, "data", dirty), 3)(jrows, jnew, jpar)
        np.testing.assert_array_equal(words(got), np.asarray(want))

    for seg, truth in ((par, True), (par ^ 1, False)):
        got = parity.verify_parity(as_words(rows), seg, dd)
        want = _zone_fn(mesh, lambda r, s: ref_parity.verify_parity(
            r, s, "data"), 2)(jrows, jax.device_put(words(seg), z))
        assert got.shape == tuple(s for i, s in enumerate(zmesh.shape)
                                  if i != dd)
        assert bool(got.all()) == truth == bool(np.asarray(want).all())

    meta = rand_u32(zmesh.shape + (3,), seed=14)
    got = coll.meta_all_gather(as_words(meta), dd, n_axes)
    want = _zone_fn(mesh, lambda x: ref_coll.meta_all_gather(x, "data"), 1)(
        jax.device_put(meta, z))
    np.testing.assert_array_equal(words(got), np.asarray(want))
    got = coll.xor_tree_reduce(as_words(meta), dd)
    want = _zone_fn(mesh, lambda x: ref_coll.xor_tree_reduce(x, "data"), 1)(
        jax.device_put(meta, z))
    np.testing.assert_array_equal(words(got), np.asarray(want))
    live = as_words(meta)
    mirror = coll.make_meta_mirror()((live, None))
    assert mirror[1] is None and torch.equal(mirror[0], live)
    assert mirror[0].data_ptr() != live.data_ptr()     # a copy, not a view


def test_collectives_fold_over_the_data_dim():
    x = rand_u32((3, 5, 2, 12), seed=9)          # data dim 1 of size 5
    t = as_words(x)
    want = np.bitwise_xor.reduce(x, axis=1)
    np.testing.assert_array_equal(words(coll.xor_fold(t, 1)), want)
    rs = coll.xor_reduce_scatter(as_words(rand_u32((3, 5, 2, 20), 1)), 1)
    assert rs.shape == (3, 5, 2, 4)
    full = coll.all_gather_row(rs, 1)
    assert full.shape == (3, 5, 2, 20)
    np.testing.assert_array_equal(words(full[:, 0]), words(full[:, 4]))
    np.testing.assert_array_equal(words(full[:, 2, :, 8:12]),
                                  words(rs[:, 2]))
    np.testing.assert_array_equal(words(coll.xor_all_reduce(t, 1)[:, 3]),
                                  want)


def test_syndrome_stack_delta_equals_rebuild():
    """Applying the bulk delta of old -> new rows to the stack of the old
    rows gives the stack of the new rows, built from numpy's XOR fold."""
    old, new = rand_u32((3, 5, 2, 20), 11), rand_u32((3, 5, 2, 20), 12)
    synd = coll.syndrome_reduce_scatter(as_words(old), 1)
    assert synd.shape == (3, 5, 2, 1, 4)
    delta = as_words(old ^ new).unsqueeze(-2)                # (*M, 1, n)
    got = coll.syndrome_apply_delta(synd, delta, 1)
    fold = np.bitwise_xor.reduce(new, axis=1).reshape(3, 2, 5, 4)
    np.testing.assert_array_equal(words(got[..., 0, :]),
                                  fold.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("shape,dim", [((4, 2, 40), 0), ((2, 5, 1, 20), 1),
                                       ((8, 1, 24), 0)])
def test_syndrome_build_by_segments_is_the_whole_build(monkeypatch, r, shape,
                                                       dim):
    """Past WEIGHTED_BYTES of weighted planes the stack is weighted and
    folded a zone segment at a time (G sdelta_stack launches): the same
    bytes as the one-launch build, and as the stack rebuilt from numpy."""
    row = as_words(rand_u32(shape, seed=r + shape[dim]))
    lead = shape[:-1]
    coeffs = None if r == 1 else as_words(rand_u32((*lead, r), seed=7))
    whole = coll.syndrome_reduce_scatter(row, dim, coeffs)
    monkeypatch.setattr(coll, "WEIGHTED_BYTES", 0)
    by_segment = coll.syndrome_reduce_scatter(row, dim, coeffs)
    assert by_segment.shape == whole.shape == (
        *lead, r, shape[-1] // shape[dim])
    assert torch.equal(by_segment, whole)
    if r == 1:
        fold = np.bitwise_xor.reduce(words(row), axis=dim)
        g = shape[dim]
        segs = fold.reshape(*fold.shape[:-1], g, -1)
        np.testing.assert_array_equal(
            words(whole[..., 0, :]), np.moveaxis(segs, -2, dim))
