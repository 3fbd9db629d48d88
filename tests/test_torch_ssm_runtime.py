"""The ssm family through the port's serving runtime (Server,
launch.serve) against the reference's, on xlstm-1.3b's
`reduced()` over the (4, 2) and (8, 1) meshes (the reference's built with
Auto axis types).

The served cache is the recurrent state alone (mLSTM's C, n, m and conv
history, sLSTM's c, n, h, m): no leaf has a time axis, so every decode
step rewrites the whole row and every commit is bulk.  As in
tests/test_torch_hybrid_runtime.py, float math differs in the last bits
between the packages, so protected bytes are compared where both see the
same values: a port server fed the reference's decode outputs ends with
the reference's pool, byte for byte.  The port's own decode gives the
reference's greedy tokens.  The Trainer is in
tests/test_torch_ssm_trainer.py.

`max_len` is chosen off every local state axis (1, 2, 3, 16, 32, 128
on (4, 2); 1, 3, 4, 16, 32, 128 on (8, 1)): the footprint rule takes any local axis of that
length for time.  `test_a_clashing_max_len_*` shows what the reference
does when it is not; the port's Server refuses such a max_len.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.base import ProtectConfig as RefProtectConfig
from repro.models.transformer import build_model as ref_build
from repro.runtime import failure as ref_failure
from repro.runtime.server import Server as RefServer
from repro_torch import Pool, convert, utils
from repro_torch.configs import registry
from repro_torch.configs.base import ProtectConfig
from repro_torch.core import layout
from repro_torch.runtime import failure
from repro_torch.runtime.server import Server
from tests import _torch_ref as tr
from tests.test_torch_hybrid_runtime import record, replay, same_pool
from tests.test_torch_trainer import Lockstep
from tests._torch_ref import compile_cache, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("compile_cache", "one_thread")

ARCH = "xlstm-1.3b"
BATCH, MAX_LEN = 8, 24
PROMPT, NEW = 6, 10


class Served:
    """A reduced model served by the reference and the port: configs,
    the reference's parameters, the prompt, and the servers."""

    def __init__(self, arch, max_len=MAX_LEN, batch=BATCH, prompt=PROMPT,
                 new=NEW, seed=0):
        self.ref_cfg = ref_registry.get_config(arch, reduced=True)
        self.cfg = registry.get_config(arch, reduced=True)
        self.params = ref_build(self.ref_cfg).init(jax.random.PRNGKey(seed))
        self.np_params = jax.tree.map(np.asarray, self.params)
        self.max_len, self.batch, self.new = max_len, batch, new
        self.prompt = np.random.default_rng(seed + 1).integers(
            0, self.cfg.vocab, (batch, prompt)).astype(np.int32)

    def port(self, mesh_name, protect=True, **kw):
        srv = Server(self.cfg, ProtectConfig(mode="mlpc", block_words=64,
                                             **kw),
                     tr.zone_mesh(mesh_name), batch=self.batch,
                     max_len=self.max_len, protect_cache=protect,
                     device="cpu")
        srv.start(convert.params_to_port(self.np_params, "cpu"))
        return srv

    def ref(self, mesh_name, **kw):
        srv = RefServer(self.ref_cfg, RefProtectConfig(
            mode="mlpc", block_words=64, **kw), tr.jax_mesh(mesh_name),
            batch=self.batch, max_len=self.max_len)
        srv.start(self.params)
        return srv

    def check(self, mesh_name, r=1, window=1):
        """The port's own decode gives the reference server's tokens and
        ends equal to a fresh open; a port server fed the reference's
        decode outputs ends with the reference server's pool, byte for
        byte, before and after the flush."""
        kw = dict(redundancy=r, window=window, scrub_period=4)
        ref = self.ref(mesh_name, **kw)
        steps = record(ref)
        want = ref.generate(jnp.asarray(self.prompt), n_new=self.new)
        own = self.port(mesh_name, **kw)
        got = own.generate(torch.from_numpy(self.prompt), n_new=self.new)
        np.testing.assert_array_equal(got, want)
        own.flush()
        same_as_fresh(own)
        fed = self.port(mesh_name, **kw)
        replay(fed, steps)
        np.testing.assert_array_equal(
            fed.generate(torch.from_numpy(self.prompt), n_new=self.new),
            want)
        mesh = tr.jax_mesh(mesh_name)
        same_pool(ref, mesh, fed)
        ref.flush()
        fed.flush()
        same_pool(ref, mesh, fed)
        assert fed.pool.step == ref.pool.step == \
            self.prompt.shape[1] + self.new - 1
        return ref, fed


def fresh_words(srv):
    pool = srv.pool
    fresh = Pool.open(pool.state, pool.state_specs, mesh=pool.mesh,
                      config=pool.config, device="cpu")
    return {k: getattr(fresh.prot, k) for k in ("row", "synd", "cksums",
                                                 "digest")}


def same_as_fresh(srv):
    for k, v in fresh_words(srv).items():
        assert torch.equal(getattr(srv.prot, k), v), k


@pytest.fixture(scope="module")
def served():
    return Served(ARCH)


@pytest.mark.parametrize("mesh_name", ["mesh42", "mesh81"])
def test_footprint_is_the_whole_row(served, mesh_name):
    """No state leaf has a local axis of length max_len: every leaf is
    dirty whole at every position, the reference's footprint, and every
    page a leaf has (all but the row's padding)."""
    ref, port = served.ref(mesh_name), served.port(mesh_name)
    lo = port.protector.layout
    assert lo.row_words == ref.protector.layout.row_words
    for pos in (0, 5, 23):
        np.testing.assert_array_equal(port._dirty_pages(pos),
                                      ref._dirty_pages(pos))
        got, want = port._dirty_words(pos), ref._dirty_words(pos)
        assert all(w is None for w in want)
        assert all(g is None for g in got) and len(got) == len(lo.slots)
    every = sorted({int(q) for i in range(len(lo.slots))
                    for q in layout.leaf_pages(lo, i)})
    assert list(port._dirty_pages(0)) == every
    assert all(not layout._slot_time_runs(sl, MAX_LEN) for sl in lo.slots)


@pytest.mark.parametrize("r,window", [(1, 1), (3, 4)])
def test_server_matches_the_reference(served, r, window):
    """On (4, 2): the synchronous engine at r = 1, the deferred one at
    r = 3 and window 4."""
    served.check("mesh42", r, window)


def test_server_on_the_wide_mesh(served):
    served.check("mesh81", 1, 4)


def test_unprotected_server_gives_equal_tokens(served):
    p = torch.from_numpy(served.prompt)
    protected = served.port("mesh42").generate(p, n_new=6)
    srv = served.port("mesh42", protect=False)
    assert srv.pool is None
    np.testing.assert_array_equal(srv.generate(p, n_new=6), protected)


@pytest.mark.parametrize("window", [1, 4])
def test_rank_loss_and_recovery(served, window):
    """A rank lost after prefill (at window 4, inside the open window)
    and recovered: the state comes back as it was, the flushed pool
    holds a fresh open's bytes; at window 1 the two packages' pools are
    byte-equal after the recovery."""
    from repro.pool import Fault as RefFault
    from repro_torch import Fault
    mesh = tr.jax_mesh("mesh42")
    ref = served.ref("mesh42", window=window)
    steps = record(ref)
    fed = served.port("mesh42", window=window)
    replay(fed, steps)
    ref.prefill(jnp.asarray(served.prompt))
    fed.prefill(torch.from_numpy(served.prompt))
    before = [convert._np_leaf(x).tobytes()
              for x in utils.tree_leaves(fed.pool.state)]
    rev = ref.pool.inject(lambda pr, s: ref_failure.inject_rank_loss(
        pr, s, rank=1))
    pev = fed.pool.inject(lambda pr, s: failure.inject_rank_loss(
        pr, s, rank=1))
    assert ref.pool.recover(RefFault.from_event(rev)).verified
    rep = fed.pool.recover(Fault.from_event(pev))
    assert rep.verified and rep.reverified
    assert [convert._np_leaf(x).tobytes()
            for x in utils.tree_leaves(fed.pool.state)] == before
    fed.flush()
    same_as_fresh(fed)
    if window == 1:
        same_pool(ref, mesh, fed)


@pytest.mark.parametrize("window", [1, 4])
def test_a_clashing_max_len_declares_a_slot_of_a_whole_leaf(window):
    """At max_len 32, the mLSTM's head_dim, the footprint rule takes the
    state's 32-long axes for time: on the layout a port Server would
    build, it declares one "slot" of leaves a step rewrites whole (n's
    slot words; C, with two such axes, stays whole), as the reference
    server does, page for page and word for word.

    The reference serves there: at window 1 the declared pages are most
    of the row, so its commits take the bulk path, and at window 4 its
    flush re-reads the state, so its pool ends equal to a fresh open of
    its cache either way.  The port's Server refuses the max_len: its
    deferred engine flushes from a live row that would hold the declared
    words only, and fall behind the state (ROADMAP queue C)."""
    from repro_torch import pool as pool_mod
    from repro_torch.models.transformer import build_model
    clash = Served(ARCH, max_len=32, new=4)
    ref = clash.ref("mesh42", window=window)
    zm = tr.zone_mesh("mesh42")
    model = build_model(clash.cfg, zm)
    lo = pool_mod.protector_for(
        zm, model.init_cache(BATCH, 32, device="meta"),
        model.cache_specs(BATCH, 32, zm),
        ProtectConfig(mode="mlpc", block_words=64, window=window)).layout
    timed = {tuple(sl.shape) for sl in lo.slots
             if layout._slot_time_runs(sl, 32)}
    assert timed == {(1, 2, 2, 32), (1, 2, 2, 32, 32)}
    for pos in (0, 7):
        np.testing.assert_array_equal(layout.time_slice_pages(lo, 32, pos),
                                      ref._dirty_pages(pos))
        for g, w in zip(layout.time_slice_words(lo, 32, pos),
                        ref._dirty_words(pos), strict=True):
            assert (g is None) == (w is None)
            if w is not None:
                np.testing.assert_array_equal(g, w)
    sliced = [tuple(sl.shape) for sl, w in zip(
        lo.slots, layout.time_slice_words(lo, 32, 0)) if w is not None]
    assert sliced == [(1, 2, 2, 32)] * 3
    with pytest.raises(ValueError, match="max_len 32 is the length"):
        clash.port("mesh42", window=window)
    ref.generate(jnp.asarray(clash.prompt), n_new=clash.new)
    ref.flush()
    cache = convert.params_to_port(
        jax.tree.map(np.asarray, ref.pool.state), "cpu")
    fresh = Pool.open(cache, model.cache_specs(BATCH, 32, zm), mesh=zm,
                      config=ProtectConfig(mode="mlpc", block_words=64),
                      device="cpu")
    want = tr.ref_fields(ref.prot, tr.jax_mesh("mesh42"))
    for k in ("row", "synd", "cksums"):
        np.testing.assert_array_equal(want[k],
                                      tr.words(getattr(fresh.prot, k)))


@pytest.mark.parametrize("mesh_name,max_len", [
    ("mesh42", 2), ("mesh42", 3), ("mesh42", 16), ("mesh42", 32),
    ("mesh42", 128), ("mesh81", 4)])
def test_the_server_refuses_every_state_axis_length(mesh_name, max_len):
    """Every local state-axis length of the reduced xLSTM but 1 (2, 3,
    16, 32, 128 on (4, 2); 4 is (8, 1)'s batch shard) is refused as a
    max_len, before a cache is allocated."""
    with pytest.raises(ValueError, match=f"max_len {max_len} is"):
        Served(ARCH, max_len=max_len).port(mesh_name)


class StateLockstep(Lockstep):
    """`Lockstep` comparing the train state as global values beside every
    word field: the reference keeps the leaves its jitted step returns,
    whose sharding GSPMD may choose apart from the leaf's spec (the
    mLSTM's (1, 8) gate-bias moments come back split over `model`); the
    rows are built through the specs either way."""

    def check(self):
        if self.ref._engine is not None:
            want = tr.epoch_fields(self.ref._est, self.mesh)
            got = convert.from_port_epoch(self.port._est)
            for k in ("dirty", "pending", "acc"):
                tr._same(want[k], got[k], k)
            want, got = want["prot"], got["prot"]
        else:
            want = tr.ref_fields(self.ref.prot, self.mesh)
            got = convert.from_port(self.port.prot)
        want["state"] = got["state"] = None
        tr.assert_same(want, got)
        for a, b in zip(jax.tree.leaves(self.ref.prot.state),
                        utils.tree_leaves(self.port.pool.state),
                        strict=True):
            assert np.asarray(a).tobytes() == convert._np_leaf(b).tobytes()
        assert self.ref.cursor == self.port.cursor
        assert self.ref._host_step == self.port._host_step


T_XL = dict(name="t_xl", family="ssm", block_pattern=("mlstm", "slstm"),
            subquadratic=True, n_layers=2, d_model=32, n_heads=4, n_kv=4,
            d_ff=0, vocab=128, param_dtype="float32",
            compute_dtype="float32")


def test_launch_serve_ssm(capsys):
    """`launch.serve` at its max_len (prompt + new + 1 = 7: off every
    state axis)."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "4",
                       "--prompt-len", "3", "--new-tokens", "3",
                       "--scrub-period", "2"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH} generated (4, 3)" in out
    assert "health: green" in out
