"""The hybrid family through the port's serving runtime (Server,
launch.serve) against the reference's, on a reduced model over the
(4, 2) and (8, 1) meshes (the reference's built with Auto axis types).
The training runtime is in tests/test_torch_hybrid_trainer.py.

The served model is recurrentgemma-2b's `reduced()` (one group of
(rglru, rglru, attn) and a tail of two rglru blocks) with its window set
to the cache's max_len, 24, so that the ring's time axis is the one the
footprint looks for, as at full width (window 2048 = max_len 2048).  Its
cache mixes three kinds of leaves: the attn block's K/V rings, sharded
on the sequence on (4, 2) (one KV head does not divide the model axis),
the ring's slot positions, and the recurrent state (conv history and h),
rewritten whole every step.

As in tests/test_torch_server.py and test_torch_trainer.py, float math
differs in the last bits between the packages, so protected bytes are
compared where both see the same values: the port's server is fed the
reference's decode outputs, and its whole pool then equals the
reference's byte for byte.
The port's own decode gives the reference's greedy tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.base import ProtectConfig as RefProtectConfig
from repro.models.transformer import build_model as ref_build
from repro.runtime.server import Server as RefServer
from repro_torch import Pool, convert, utils
from repro_torch.configs import registry
from repro_torch.configs.base import ProtectConfig
from repro_torch.core import layout
from repro_torch.runtime.server import Server
from tests import _torch_ref as tr
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

BATCH, MAX_LEN = 8, 24
PROMPT, NEW = 6, 24            # to position 29: the ring of 24 wraps


def hybrid_cfgs():
    ref = dataclasses.replace(
        ref_registry.get_config("recurrentgemma-2b", reduced=True),
        window=MAX_LEN)
    port = dataclasses.replace(
        registry.get_config("recurrentgemma-2b", reduced=True),
        window=MAX_LEN)
    return ref, port


@pytest.fixture(scope="module")
def served():
    ref_cfg, cfg = hybrid_cfgs()
    params = ref_build(ref_cfg).init(jax.random.PRNGKey(0))
    return dict(ref_cfg=ref_cfg, cfg=cfg, params=params,
                np_params=jax.tree.map(np.asarray, params))


def prompt(seed):
    return np.random.default_rng(seed).integers(
        0, 512, (BATCH, PROMPT)).astype(np.int32)


def port_server(s, mesh_name, **kw):
    srv = Server(s["cfg"], ProtectConfig(mode="mlpc", block_words=64, **kw),
                 tr.zone_mesh(mesh_name), batch=BATCH, max_len=MAX_LEN,
                 device="cpu")
    srv.start(convert.params_to_port(s["np_params"], "cpu"))
    return srv


def ref_server(s, mesh_name, **kw):
    srv = RefServer(s["ref_cfg"], RefProtectConfig(
        mode="mlpc", block_words=64, **kw), tr.jax_mesh(mesh_name),
        batch=BATCH, max_len=MAX_LEN)
    srv.start(s["params"])
    return srv


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def record(srv):
    steps, decode = [], srv._decode

    def wrapped(params, tokens, cache, pos):
        out = decode(params, tokens, cache, pos)
        steps.append((np_tree(cache),) + tuple(np_tree(o) for o in out))
        return out
    srv._decode = wrapped
    return steps


def replay(srv, steps):
    it = iter(steps)

    def decode(params, tokens, cache, pos):
        cache_in, tok, logits, new = next(it)
        got = utils.tree_leaves(utils.tree_map(convert._np_leaf, cache))
        for want, leaf in zip(jax.tree.leaves(cache_in), got, strict=True):
            assert want.tobytes() == leaf.tobytes(), f"input cache at {pos}"
        return (torch.from_numpy(tok.copy()), torch.from_numpy(logits.copy()),
                convert.params_to_port(new, "cpu"))
    srv._decode = decode


def same_pool(ref_srv, mesh, port_srv):
    """The two servers' protected state byte-equal: every word field (and
    the open window's) zone-stacked, the cache as its global value.  The
    reference keeps the cache leaves its jitted decode returns, whose
    sharding GSPMD may choose apart from the leaf's spec (on (4, 2) the
    ring's `pos` comes back split over `model` like the K/V it is
    written beside); the row is built through the specs either way."""
    def fields(ref_fields, port_fields):
        for f in (ref_fields, port_fields):
            f["state"] = None
        tr.assert_same(ref_fields, port_fields)
    if ref_srv._engine is not None:
        want = tr.epoch_fields(ref_srv._est, mesh)
        got = convert.from_port_epoch(port_srv._est)
        fields(want["prot"], got["prot"])
        for k in ("dirty", "pending", "acc"):
            tr._same(want[k], got[k], k)
    else:
        fields(tr.ref_fields(ref_srv.prot, mesh),
               convert.from_port(port_srv.prot))
    for want, got in zip(jax.tree.leaves(ref_srv.pool.state),
                         utils.tree_leaves(port_srv.pool.state),
                         strict=True):
        assert np.asarray(want).tobytes() == \
            convert._np_leaf(got).tobytes()


@pytest.mark.parametrize("mesh_name", ["mesh42", "mesh81"])
def test_footprints_are_the_references(served, mesh_name):
    """The decode footprint the server hands its pool, page and word
    forms, at positions before and after the ring wraps.  The reference's
    rule: a leaf with no local axis of length max_len is dirty whole.  On
    (4, 2) the K/V rings hold half the sequence a model rank, so they are
    dirty whole, with the recurrent state: nearly the whole row, the bulk
    path.  On (8, 1) they keep the sequence whole: a time slot a leaf,
    plus the recurrent state."""
    ref, port = ref_server(served, mesh_name), port_server(served, mesh_name)
    lo = port.protector.layout
    assert lo.row_words == ref.protector.layout.row_words
    for pos in (0, 5, 23, 24, 29):
        np.testing.assert_array_equal(port._dirty_pages(pos),
                                      ref._dirty_pages(pos))
        got, want = port._dirty_words(pos), ref._dirty_words(pos)
        assert len(got) == len(want) == len(lo.slots)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)
    whole = [w is None for w in port._dirty_words(0)]
    rings = [i for i, sl in enumerate(lo.slots) if len(sl.shape) == 5]
    slots = [i for i, sl in enumerate(lo.slots) if sl.dtype == torch.int32]
    state = sorted(set(range(len(lo.slots))) - set(rings) - set(slots))
    assert len(rings) == 2 and len(slots) == 1 and len(state) == 8
    # the recurrent state is dirty whole on either mesh; `pos` never is
    assert all(whole[i] for i in state) and not whole[slots[0]]
    pages = set(port._dirty_pages(0))
    ring_pages = [set(layout.leaf_pages(lo, i).tolist()) for i in rings]
    if mesh_name == "mesh42":
        assert all(whole[i] for i in rings)
        assert all(p <= pages for p in ring_pages)
    else:
        assert not any(whole[i] for i in rings)
        assert not any(p <= pages for p in ring_pages)


def check_server(served, mesh_name, r, window):
    """The port's own decode gives the reference server's tokens and ends
    equal to a fresh open; a port server fed the reference's decode
    outputs ends with the reference server's pool, byte for byte, before
    and after the flush."""
    kw = dict(redundancy=r, window=window, scrub_period=4)
    p = prompt(1)
    ref = ref_server(served, mesh_name, **kw)
    steps = record(ref)
    want = ref.generate(jnp.asarray(p), n_new=NEW)
    own = port_server(served, mesh_name, **kw)
    got = own.generate(torch.from_numpy(p), n_new=NEW)
    np.testing.assert_array_equal(got, want)
    own.flush()
    fresh = Pool.open(own.pool.state, own.pool.state_specs,
                      mesh=own.pool.mesh, config=own.pool.config,
                      device="cpu")
    for k in ("row", "synd", "cksums", "digest"):
        assert torch.equal(getattr(own.prot, k), getattr(fresh.prot, k)), k
    fed = port_server(served, mesh_name, **kw)
    replay(fed, steps)
    np.testing.assert_array_equal(
        fed.generate(torch.from_numpy(p), n_new=NEW), want)
    mesh = tr.jax_mesh(mesh_name)
    same_pool(ref, mesh, fed)
    ref.flush()
    fed.flush()
    same_pool(ref, mesh, fed)
    assert fed.pool.step == ref.pool.step == PROMPT + NEW - 1


@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("r", [1, 3])
def test_server_matches_the_reference(served, r, window):
    """On (4, 2), every commit bulk; (8, 1) is in
    tests/test_torch_hybrid_wide.py."""
    check_server(served, "mesh42", r, window)


def test_unprotected_server_gives_equal_tokens(served):
    p = torch.from_numpy(prompt(2))
    protected = port_server(served, "mesh42").generate(p, n_new=8)
    srv = Server(served["cfg"], ProtectConfig(mode="mlpc", block_words=64),
                 tr.zone_mesh("mesh42"), batch=BATCH, max_len=MAX_LEN,
                 protect_cache=False, device="cpu")
    srv.start(convert.params_to_port(served["np_params"], "cpu"))
    assert srv.pool is None
    np.testing.assert_array_equal(srv.generate(p, n_new=8), protected)


def test_launch_serve_hybrid(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "recurrentgemma-2b", "--device", "cpu",
                       "--batch", "4", "--prompt-len", "3",
                       "--new-tokens", "3", "--scrub-period", "2"]) == 0
    out = capsys.readouterr().out
    assert "arch=recurrentgemma-2b generated (4, 3)" in out
    assert "health: green" in out


def test_window_footprint_layout_kinds(served):
    """The ring's time axis is the cache's max_len (window = max_len), so
    `_slot_time_runs` names one axis on every K/V and `pos` leaf of the
    (8, 1) layout and none on a recurrent leaf."""
    srv = port_server(served, "mesh81")
    runs = [len(layout._slot_time_runs(sl, MAX_LEN))
            for sl in srv.protector.layout.slots]
    assert sorted(runs) == [0] * (len(runs) - 3) + [1, 1, 1]


@pytest.mark.parametrize("window", [1, 4])
def test_recovery_restores_the_cache_only_on_the_sync_engine(served,
                                                             window):
    """A rank lost after prefill (at window 4, two commits into an open
    window) and recovered: the port's cache comes back as it was and its
    flushed pool holds the bytes of a pool opened over it.  The
    reference restores the cache only on its synchronous engine (window
    1), where the two pools are byte-equal after the recovery: its patch
    engine's flush splices the damaged state into the row (ROADMAP queue
    C), while the port's flushes from the window's live row."""
    from repro.pool import Fault as RefFault
    from repro_torch import Fault
    from repro_torch.runtime import failure
    from repro.runtime import failure as ref_failure
    mesh = tr.jax_mesh("mesh42")
    ref = ref_server(served, "mesh42", window=window)
    steps = record(ref)
    fed = port_server(served, "mesh42", window=window)
    replay(fed, steps)
    p = prompt(3)
    ref.prefill(jnp.asarray(p))
    fed.prefill(torch.from_numpy(p))
    assert fed.pool.engine is None if window == 1 else \
        fed.pool.engine.needs_flush
    before = [convert._np_leaf(x).tobytes()
              for x in utils.tree_leaves(fed.pool.state)]
    fresh = Pool.open(fed.pool.state, fed.pool.state_specs,
                      mesh=fed.pool.mesh, config=fed.pool.config,
                      device="cpu")
    rev = ref.pool.inject(lambda pr, s: ref_failure.inject_rank_loss(
        pr, s, rank=1))
    pev = fed.pool.inject(lambda pr, s: failure.inject_rank_loss(
        pr, s, rank=1))
    assert ref.pool.recover(RefFault.from_event(rev)).verified
    rep = fed.pool.recover(Fault.from_event(pev))
    assert rep.verified and rep.reverified
    after = [convert._np_leaf(x).tobytes()
             for x in utils.tree_leaves(fed.pool.state)]
    assert after == before
    fed.flush()
    for k in ("row", "synd", "cksums", "digest"):
        assert torch.equal(getattr(fed.prot, k), getattr(fresh.prot, k)), k
    if window == 1:
        same_pool(ref, mesh, fed)
