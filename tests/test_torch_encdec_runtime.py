"""The encoder-decoder family through the port's runtimes (Server,
Trainer, launch.serve, launch.train) against the reference's, on
seamless-m4t-large-v2's `reduced()` (2 + 2 layers, 4 KV heads of 16:
two a rank on (4, 2)) over the (4, 2) and (8, 1) meshes (the
reference's built with Auto axis types).  The model is in
tests/test_torch_encdec.py.

The served cache holds each decoder layer's self-attention K/V and slot
positions and its cross K/V (`cross`, (layers, batch, max_len, K, hd)).
The reference's `Server` never encodes a source: `start` opens the pool
over zeros.  Here, as on the card, both packages' servers are filled
after `start` with the reference's cross K/V of a seeded source of
max_len frames: one bulk commit with verify_old on the synchronous
engine, a fresh open (`Pool.init`) on the deferred one.  The footprint
rule (`layout._slot_time_runs`) takes any local axis of length max_len
for time, so a decode step declares a slot of the cross leaves too,
which it never writes; max_len 24 is off every other local axis (16 is
head_dim: `test_a_clashing_max_len_*`).

As in tests/test_torch_hybrid_runtime.py, float math differs in the last
bits between the packages, so protected bytes are compared where both
see the same values: a port server fed the reference's decode outputs
ends with the reference's pool, byte for byte; the port's own decode
gives the reference's greedy tokens.  The served weights are
`chip_smoke.soft_attention`'s (the card's): at the reference's init the
cross attention is one-hot (tests/test_torch_encdec.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

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
from tests.test_torch_encdec import soft
from tests.test_torch_hybrid_runtime import record, replay, same_pool
from tests.test_torch_ssm_runtime import StateLockstep, same_as_fresh
from tests._torch_ref import compile_cache, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("compile_cache", "one_thread")

ARCH = "seamless-m4t-large-v2"
BATCH, MAX_LEN = 8, 24
PROMPT, NEW = 6, 10


class EncServed:
    """The reduced model served by both packages: configs, the soft
    weights, a prompt, and the reference's cross K/V of a seeded source
    of MAX_LEN frames (std 0.02, the synthetic stream's scale)."""

    def __init__(self, max_len=MAX_LEN, seed=0):
        self.ref_cfg = ref_registry.get_config(ARCH, reduced=True)
        self.cfg = registry.get_config(ARCH, reduced=True)
        self.params, self.pp = soft(self.ref_cfg, seed)
        self.np_params = jax.tree.map(np.asarray, self.params)
        self.max_len = max_len
        rng = np.random.default_rng(seed + 1)
        self.prompt = rng.integers(0, self.cfg.vocab,
                                   (BATCH, PROMPT)).astype(np.int32)
        self.src = (rng.standard_normal((BATCH, max_len, self.cfg.d_model))
                    * 0.02).astype(np.float32)

    @functools.cached_property
    def cross(self):
        model = ref_build(self.ref_cfg)
        return jax.tree.map(np.asarray, model.build_cross_cache(
            self.params, model.encode(self.params, jnp.asarray(self.src))))

    def port(self, mesh_name, protect=True, fill=True, **kw):
        srv = Server(self.cfg, ProtectConfig(mode="mlpc", block_words=64,
                                             **kw),
                     tr.zone_mesh(mesh_name), batch=BATCH,
                     max_len=self.max_len, protect_cache=protect,
                     device="cpu")
        srv.start(convert.params_to_port(self.np_params, "cpu"))
        if fill:
            cache = dict(srv.pool.state if protect else srv.cache,
                         cross=convert.params_to_port(self.cross, "cpu"))
            if not protect:
                srv.cache = cache
            elif srv.pool.engine is None:
                assert bool(srv.pool.commit(cache, verify_old=True))
            else:
                srv.pool.init(cache)
        return srv

    def ref(self, mesh_name, fill=True, **kw):
        mesh = tr.jax_mesh(mesh_name)
        srv = RefServer(self.ref_cfg, RefProtectConfig(
            mode="mlpc", block_words=64, **kw), mesh, batch=BATCH,
            max_len=self.max_len)
        srv.start(self.params)
        if fill:
            specs = srv.model.cache_specs(BATCH, self.max_len, mesh)
            cross = {n: jax.device_put(v, NamedSharding(
                mesh, specs["cross"][n])) for n, v in self.cross.items()}
            # fresh buffers: the pool donates its state into a commit
            cache = dict(jax.tree.map(jnp.copy, srv.pool.state),
                         cross=cross)
            if srv.pool.engine is None:
                assert bool(srv.pool.commit(cache, verify_old=True))
            else:
                srv.pool.init(cache)
        return srv


@pytest.fixture(scope="module")
def served():
    return EncServed()


def footprints(srv, pos):
    return srv._dirty_pages(pos), srv._dirty_words(pos)


@pytest.mark.parametrize("mesh_name", ["mesh42", "mesh81"])
def test_footprints_are_the_references(served, mesh_name):
    """Page for page and word for word at positions 0, 5 and 23: a time
    slot of each self and each cross K/V leaf and of `pos` — the cross
    slot declared though a step never writes it, as many words as the
    self cache's."""
    ref = RefServer(served.ref_cfg, RefProtectConfig(mode="mlpc",
                                                     block_words=64),
                    tr.jax_mesh(mesh_name), batch=BATCH, max_len=MAX_LEN)
    port = served.port(mesh_name, fill=False)
    lo = port.protector.layout
    assert lo.row_words == ref.protector.layout.row_words
    for pos in (0, 5, 23):
        pages, words = footprints(port, pos)
        np.testing.assert_array_equal(pages, ref._dirty_pages(pos))
        want = ref._dirty_words(pos)
        assert len(words) == len(want) == len(lo.slots) == 5
        for g, w in zip(words, want):
            assert g is not None and w is not None
            np.testing.assert_array_equal(g, w)
        # leaves in order: cross k, cross v, self k, pos, self v
        assert len(words[0]) == len(words[1]) == len(words[2]) == len(
            words[4]) > 0
    assert len(port._dirty_pages(0)) < lo.n_blocks * \
        port.protector.hybrid_threshold


def test_a_clashing_max_len_declares_whole_leaves():
    """At max_len 16, the reduced head_dim, every K/V leaf (self and
    cross) has two local axes of that length, so both packages declare
    it whole, and a step's pages are the four K/V leaves' every page;
    `pos` keeps its slot.  The port's Server serves there (the leaves
    grow with max_len: no state axis clashes), as the reference's."""
    clash = EncServed(max_len=16)
    ref = RefServer(clash.ref_cfg, RefProtectConfig(mode="mlpc",
                                                    block_words=64),
                    tr.jax_mesh("mesh42"), batch=BATCH, max_len=16)
    port = clash.port("mesh42", fill=False)
    lo = port.protector.layout
    pages, words = footprints(port, 3)
    np.testing.assert_array_equal(pages, ref._dirty_pages(3))
    want = ref._dirty_words(3)
    assert [w is None for w in words] == [w is None for w in want] == [
        True, True, True, False, True]
    np.testing.assert_array_equal(words[3], want[3])
    kv_pages = {int(q) for i in (0, 1, 2, 4)
                for q in layout.leaf_pages(lo, i)}
    assert kv_pages <= set(pages)


@pytest.mark.parametrize("window", [1, 4])
def test_the_filled_cross_cache_is_the_references(served, window):
    """After `start`, the reference's cross K/V written in: a bulk
    verify_old commit at window 1, a fresh open at window 4 (whose patch
    engine's flush takes a decode step's page capacity); the two pools
    byte-equal, equal to a fresh open of the filled cache."""
    mesh = tr.jax_mesh("mesh42")
    ref = served.ref("mesh42", window=window)
    port = served.port("mesh42", window=window)
    same_pool(ref, mesh, port)
    same_as_fresh(port)
    got = port.pool.state["cross"]
    for n in ("k", "v"):
        assert convert._np_leaf(got[n]).tobytes() == \
            served.cross[n].tobytes()
    assert port.pool.step == ref.pool.step == (1 if window == 1 else 0)


def test_a_fill_past_the_patch_engines_capacity():
    """At window 4 a server's patch engine takes a decode step's pages a
    commit; its flush gathers that many a step of the window.  The cache
    with filled cross leaves, committed with every leaf declared whole
    (max_len 200, where the flush patches pages): the port refuses the
    commit; the reference's flush keeps the first pages and drops the
    rest, so its next scrub finds the pages past the capacity bad and
    cannot repair them (ROADMAP queue C)."""
    wide = EncServed(max_len=200)
    port = wide.port("mesh42", fill=False, window=4)
    eng = port.pool.engine
    assert eng.flush_patch and eng.flush_capacity < \
        port.protector.layout.n_blocks
    cache = dict(port.pool.state, cross=convert.params_to_port(
        wide.cross, "cpu"))
    with pytest.raises(ValueError, match="past the"):
        port.pool.commit(cache)
    ref = wide.ref("mesh42", fill=False, window=4)
    mesh = tr.jax_mesh("mesh42")
    specs = ref.model.cache_specs(BATCH, 200, mesh)
    cross = {n: jax.device_put(v, NamedSharding(mesh, specs["cross"][n]))
             for n, v in wide.cross.items()}
    ref.pool.commit(dict(jax.tree.map(jnp.copy, ref.pool.state),
                         cross=cross))
    ref.pool.flush()
    rep = ref.pool.scrub()
    pages = sorted({p for _, p in rep.bad_locations})
    assert pages and pages[0] >= eng.flush_capacity
    assert rep.synd_ok == [False] and not rep.repair_ok


@pytest.mark.parametrize("mesh_name,r,window", [
    ("mesh42", 1, 1), ("mesh42", 3, 4), ("mesh81", 1, 4)])
def test_server_matches_the_reference(served, mesh_name, r, window):
    """Over a generation on the filled cross cache: the port's own decode
    gives the reference server's tokens and ends equal to a fresh open; a
    port server fed the reference's decode outputs ends with the
    reference server's pool, byte for byte, before and after the flush;
    the cross leaves are the filled ones at the end."""
    kw = dict(redundancy=r, window=window, scrub_period=4)
    ref = served.ref(mesh_name, **kw)
    steps = record(ref)
    want = ref.generate(jnp.asarray(served.prompt), n_new=NEW)
    own = served.port(mesh_name, **kw)
    got = own.generate(torch.from_numpy(served.prompt), n_new=NEW)
    np.testing.assert_array_equal(got, want)
    own.flush()
    same_as_fresh(own)
    fed = served.port(mesh_name, **kw)
    replay(fed, steps)
    np.testing.assert_array_equal(
        fed.generate(torch.from_numpy(served.prompt), n_new=NEW), want)
    mesh = tr.jax_mesh(mesh_name)
    same_pool(ref, mesh, fed)
    ref.flush()
    fed.flush()
    same_pool(ref, mesh, fed)
    for n in ("k", "v"):
        assert convert._np_leaf(own.pool.state["cross"][n]).tobytes() == \
            served.cross[n].tobytes()


def test_unprotected_server_gives_equal_tokens(served):
    """Filled, protected and unprotected: equal tokens; the unprotected
    cache's cross leaves stay the very tensors the fill gave it."""
    p = torch.from_numpy(served.prompt)
    protected = served.port("mesh42").generate(p, n_new=6)
    srv = served.port("mesh42", protect=False)
    assert srv.pool is None
    cross = srv.cache["cross"]
    np.testing.assert_array_equal(srv.generate(p, n_new=6), protected)
    assert all(srv.cache["cross"][n] is cross[n] for n in ("k", "v"))


def test_zero_cross_serving_matches_the_reference(served):
    """The reference's own serving, no fill: the decode over the zero
    cross cache, tokens equal; the pool's cross leaves still zero."""
    ref = served.ref("mesh42", fill=False)
    port = served.port("mesh42", fill=False)
    want = ref.generate(jnp.asarray(served.prompt), n_new=4)
    np.testing.assert_array_equal(
        port.generate(torch.from_numpy(served.prompt), n_new=4), want)
    assert all(not bool(x.any()) for x in port.pool.state["cross"].values())
    assert all(not np.asarray(x).any() for x in ref.pool.state["cross"]
               .values())


def test_scribble_on_a_cross_page_is_repaired(served):
    """After prefill, words of rank 0's cross K shard scribbled in both
    pools: each scrub finds the same pages and repairs them; the cache
    comes back and the two pools are byte-equal."""
    mesh = tr.jax_mesh("mesh42")
    ref = served.ref("mesh42")
    steps = record(ref)
    fed = served.port("mesh42")
    replay(fed, steps)
    ref.prefill(jnp.asarray(served.prompt))
    fed.prefill(torch.from_numpy(served.prompt))
    lo = fed.protector.layout
    sl = lo.slots[0]
    offsets = [sl.offset + 3, sl.offset + sl.n_words // 2]
    before = [convert._np_leaf(x).tobytes()
              for x in utils.tree_leaves(fed.pool.state)]
    ref.pool.inject(lambda pr, s: ref_failure.inject_scribble(
        pr, s, rank=0, word_offsets=offsets))
    fed.pool.inject(lambda pr, s: failure.inject_scribble(
        pr, s, rank=0, word_offsets=offsets))
    rrep, prep = ref.pool.scrub(), fed.pool.scrub()
    want = {(0, o // lo.block_words) for o in offsets}
    assert set(prep.bad_locations) == set(rrep.bad_locations) == want
    assert prep.repaired and prep.repair_ok and rrep.repair_ok
    assert [convert._np_leaf(x).tobytes()
            for x in utils.tree_leaves(fed.pool.state)] == before
    same_pool(ref, mesh, fed)


@pytest.mark.parametrize("window", [1, 4])
def test_rank_loss_and_recovery(served, window):
    """A rank lost after prefill (at window 4, inside the open window)
    and recovered: the port's cache, the cross leaves included, comes
    back as it was, its flushed pool holds a fresh open's bytes; at
    window 1 the two packages' pools are byte-equal after the recovery
    (at window 4 the reference's patch engine recovers to the damaged
    words, ROADMAP queue C)."""
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


T_ED = dict(name="t_ed", family="audio", enc_layers=2, n_layers=2,
            d_model=32, n_heads=4, n_kv=2, d_ff=64, vocab=128,
            param_dtype="float32", compute_dtype="float32")


def test_trainer_steps_keep_the_pool_byte_equal():
    """The port's Trainer in lockstep with the reference's (its step
    replaying the reference's; the batches carry `src_embeds`): bulk
    steps, verify_old, a rank loss and recovery; the pools byte-equal
    after every step."""
    ls = StateLockstep(model=T_ED)
    ls.run(2)
    ls.port.verify_old = ls.ref.verify_old = True
    ls.step()
    rev, pev = ls.inject(
        lambda p, s: ref_failure.inject_rank_loss(p, s, rank=1),
        lambda p, s: failure.inject_rank_loss(p, s, rank=1))
    assert ls.recover(rev, pev)["verified"]
    ls.step()


def test_launch_serve_encdec(capsys):
    """`launch.serve` on the reduced config: the reference's serving, the
    decode over the zero cross cache `start` opens (max_len 7)."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "4",
                       "--prompt-len", "3", "--new-tokens", "3",
                       "--scrub-period", "2"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH} generated (4, 3)" in out
    assert "health: green" in out


def test_launch_train_encdec(capsys):
    """`launch.train` on the reduced config: the synthetic stream's
    batches carry `src_embeds` (seq_len frames)."""
    from repro_torch.launch import train
    assert train.main(["--arch", ARCH, "--reduced", "--steps", "2",
                       "--seq-len", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "final: step 2" in out and "health: green" in out
