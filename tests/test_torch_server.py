"""The port's serving plane (repro_torch.runtime.server, launch.serve)
against the reference's Server, on the reduced t_srv model of
tests/test_checkpoint_server.py (2 layers, d_model 32, f32) over the
(4, 2) mesh, the parameters the reference's seed-0 init.

Two ways of holding the port to the reference:

  * Tokens: the port's own decode gives the reference's greedy tokens.
  * Protected bytes: each package's float math rounds differently (the
    caches agree to ~1e-5, not bit for bit), so the protected state is
    compared where both see the same cache: the port's server is fed the
    reference's decode outputs step by step (its `_decode` replays them),
    and after the last step its whole pool — state, row, syndromes,
    checksums, digest, redo log, the open window — is byte-equal to the
    reference server's.  The port's own run is held to a pool opened
    fresh over its final cache.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import ProtectConfig as RefProtectConfig
from repro.models.transformer import build_model as ref_build
from repro.runtime.server import Server as RefServer
from repro_torch import Pool, convert, utils
from repro_torch.configs.base import ModelConfig, ProtectConfig
from repro_torch.core.scrub import Scrubber
from repro_torch.runtime import failure
from repro_torch.runtime.server import Server
from tests import _torch_ref as tr
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

T_SRV = dict(name="t_srv", family="dense", n_layers=2, d_model=32,
             n_heads=4, n_kv=2, d_ff=64, vocab=128, param_dtype="float32",
             compute_dtype="float32")
BATCH, MAX_LEN = 4, 32


@pytest.fixture(scope="module")
def served():
    mesh, zmesh = tr.jax_mesh("mesh42"), tr.zone_mesh("mesh42")
    ref_cfg, cfg = RefModelConfig(**T_SRV), ModelConfig(**T_SRV)
    params = ref_build(ref_cfg, mesh).init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    return dict(mesh=mesh, zmesh=zmesh, ref_cfg=ref_cfg, cfg=cfg,
                params=params, np_params=np_params)


def prompt(seed, length=6):
    return np.random.default_rng(seed).integers(
        0, T_SRV["vocab"], (BATCH, length)).astype(np.int32)


def port_server(s, protect="mlpc", **kw):
    srv = Server(s["cfg"], ProtectConfig(mode=protect, block_words=64, **kw),
                 s["zmesh"], batch=BATCH, max_len=MAX_LEN, device="cpu")
    srv.start(convert.params_to_port(s["np_params"], "cpu"))
    return srv


def ref_server(s, **kw):
    srv = RefServer(s["ref_cfg"], RefProtectConfig(mode="mlpc",
                                                   block_words=64, **kw),
                    s["mesh"], batch=BATCH, max_len=MAX_LEN)
    srv.start(s["params"])
    return srv


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def record(srv):
    """Wrap a reference server's decode: each step's (input cache, next
    tokens, logits, new cache) as numpy."""
    steps, decode = [], srv._decode

    def wrapped(params, tokens, cache, pos):
        out = decode(params, tokens, cache, pos)
        steps.append((np_tree(cache),) + tuple(np_tree(o) for o in out))
        return out
    srv._decode = wrapped
    return steps


def replay(srv, steps):
    """Make a port server's decode return the reference's recorded
    outputs, after checking that it hands decode the reference's input
    cache byte for byte."""
    it = iter(steps)

    def decode(params, tokens, cache, pos):
        cache_in, tok, logits, new = next(it)
        got = utils.tree_leaves(utils.tree_map(convert._np_leaf, cache))
        for want, leaf in zip(jax.tree.leaves(cache_in), got, strict=True):
            assert want.tobytes() == leaf.tobytes(), f"input cache at {pos}"
        return (torch.from_numpy(tok.copy()), torch.from_numpy(logits.copy()),
                convert.params_to_port(new, "cpu"))
    srv._decode = decode


def fields(prot):
    return {k: convert._np_words(getattr(prot, k))
            for k in ("row", "synd", "cksums", "digest")}


def same_as_fresh(srv):
    """The pool, flushed, holds the bytes of a pool opened fresh over its
    final cache."""
    srv.flush()
    fresh = Pool.open(srv.pool.state, srv.pool.state_specs,
                      mesh=srv.pool.mesh, config=srv.pool.config,
                      device="cpu")
    for k, want in fields(fresh.prot).items():
        got = fields(srv.prot)[k]
        assert got.tobytes() == want.tobytes(), k


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("r", [1, 3])
def test_server_matches_the_reference(served, r, window, depth):
    kw = dict(redundancy=r, window=window, pipeline_depth=depth,
              scrub_period=4)
    p = prompt(1)
    ref = ref_server(served, **kw)
    steps = record(ref)
    want = ref.generate(jnp.asarray(p), n_new=5)
    # the port's own decode: the reference's tokens
    own = port_server(served, **kw)
    got = own.generate(torch.from_numpy(p), n_new=5)
    np.testing.assert_array_equal(got, want)
    assert own.pool.engine is not None if window > 1 else \
        own.pool.engine is None
    assert own.pool.in_flight == 0 and own.pos == 10
    assert own.pool.metrics.counter("server_steps_total").value == 10
    same_as_fresh(own)
    # fed the reference's caches: its whole protected state, byte for byte
    fed = port_server(served, **kw)
    replay(fed, steps)
    np.testing.assert_array_equal(
        fed.generate(torch.from_numpy(p), n_new=5), want)
    if window > 1:
        want_e = tr.epoch_fields(ref._est, served["mesh"])
        got_e = convert.from_port_epoch(fed._est)
        tr.assert_same(want_e["prot"], got_e["prot"])
        for k in ("dirty", "pending", "acc"):
            tr._same(want_e[k], got_e[k], k)
    tr.assert_prot_same(ref.prot, served["mesh"], fed.prot)
    ref.flush()
    fed.flush()
    tr.assert_prot_same(ref.prot, served["mesh"], fed.prot)
    assert fed.pool.step == ref.pool.step == 10


@pytest.mark.parametrize("protect", ["mlpc", "none"])
def test_unprotected_server_gives_equal_tokens(served, protect):
    """protect_cache=False (or mode none): no pool, the same tokens as
    the protected server's."""
    p = torch.from_numpy(prompt(2))
    protected = port_server(served).generate(p, n_new=5)
    srv = Server(served["cfg"], ProtectConfig(mode=protect, block_words=64),
                 served["zmesh"], batch=BATCH, max_len=MAX_LEN,
                 protect_cache=False, window=7, device="cpu")
    srv.start(convert.params_to_port(served["np_params"], "cpu"))
    assert srv.pool is None and srv.prot is None and srv.protector is None
    srv.flush()
    np.testing.assert_array_equal(srv.generate(p, n_new=5), protected)
    with pytest.raises(ValueError):
        srv.prot = object()


def test_window_override_folds_into_the_config(served):
    srv = Server(served["cfg"], ProtectConfig(mode="mlpc", block_words=64),
                 served["zmesh"], batch=BATCH, max_len=MAX_LEN, window=4,
                 device="cpu")
    assert srv.pool.config.window == 4 and srv.pool.engine.window == 4
    assert srv.window == 4


def test_server_cache_scribble_recovery(served):
    """tests/test_checkpoint_server.py's case: corrupt rank 0's cache
    shard after prefill, scrub and repair; decoding continues and gives
    the clean run's tokens, from a cache byte-equal to the clean run's."""
    p = torch.from_numpy(prompt(3))
    clean = port_server(served)
    rows = {}
    clean.add_step_hook(lambda srv, out: rows.setdefault(
        out["pos"], srv.prot.row.clone()))
    want = clean.generate(p, n_new=6)

    srv = port_server(served)
    tok = srv.prefill(p)
    bad_prot, event = failure.inject_scribble(srv.protector, srv.prot,
                                              rank=0, word_offsets=[11])
    srv.prot = bad_prot
    scrubber = Scrubber(srv.protector, period=1)
    srv.prot, report = scrubber.run(srv.prot)
    assert report.bad_locations and report.repair_ok
    assert torch.equal(srv.prot.row, rows[5])
    out = [tok]
    for _ in range(5):
        tok = srv.step(tok)
        out.append(tok)
    np.testing.assert_array_equal(torch.stack(out, 1).numpy(), want)
    assert torch.equal(srv.prot.row, rows[10])


@pytest.mark.parametrize("fault", ["rank_loss", "scribble"])
@pytest.mark.parametrize("window", [1, 4])
def test_mid_window_fault_restores_the_cache(served, window, fault):
    """A fault after a prefill of six commits (at window 4 two of them in
    an open window): a rank loss recovered, or a scribble on the last
    step's words that the scrub finds and repairs, hands back the cache
    as it was, and decoding goes on to the clean run's tokens.  The
    deferred engine's flush takes the window's live row, not the damaged
    state (the reference's splices the state in: ROADMAP queue C)."""
    from repro_torch import Fault
    p = torch.from_numpy(prompt(5))
    want = port_server(served, window=window).generate(p, n_new=6)
    srv = port_server(served, window=window)
    tok = srv.prefill(p)
    assert srv.pool.engine is None if window == 1 else \
        srv.pool.engine.needs_flush
    before = [x.clone() for x in utils.tree_leaves(srv.pool.state)]
    if fault == "rank_loss":
        ev = srv.pool.inject(lambda pr, s: failure.inject_rank_loss(
            pr, s, rank=1))
        rep = srv.pool.recover(Fault.from_event(ev))
        assert rep.verified and rep.reverified
    else:
        lo = srv.protector.layout
        offsets = [sl.offset + int(w[0]) for sl, w in
                   zip(lo.slots, srv._dirty_words(srv.pos - 1))]
        srv.pool.inject(lambda pr, s: failure.inject_scribble(
            pr, s, rank=0, word_offsets=offsets))
        report = srv.pool.scrub()
        assert {(0, o // lo.block_words) for o in offsets} == \
            set(report.bad_locations)
        assert report.repaired and report.repair_ok
    for a, b in zip(before, utils.tree_leaves(srv.pool.state),
                    strict=True):
        assert torch.equal(a, b)
    out = [tok]
    for _ in range(5):
        tok = srv.step(tok)
        out.append(tok)
    np.testing.assert_array_equal(torch.stack(out, 1).numpy(), want)


def test_aborted_step_leaves_the_pool_untouched(served):
    """A decode step builds its new cache in a fresh copy: decoding from
    the pool's state and aborting the commit leaves every byte of the
    pool as it was (the aborted redo record aside, as in the reference),
    and the next commit of the same step goes through."""
    srv = port_server(served)
    tok = srv.prefill(torch.from_numpy(prompt(4)))
    before = convert.from_port(srv.prot)
    nxt, _, new_cache = srv._decode(srv.params, tok, srv._current_cache(),
                                    srv.pos)
    assert not torch.equal(new_cache["groups"]["b0_dense"]["k"],
                           srv.pool.state["groups"]["b0_dense"]["k"])
    ok = srv.pool.commit(new_cache, dirty_pages=srv._dirty_pages(srv.pos),
                         canary_ok=False)
    assert not bool(ok)
    after = convert.from_port(srv.prot)
    for k in ("row", "synd", "cksums", "digest", "step"):
        assert after[k].tobytes() == before[k].tobytes(), k
    for k, leaf in before["state"]["groups"]["b0_dense"].items():
        assert after["state"]["groups"]["b0_dense"][k].tobytes() == \
            leaf.tobytes(), k
    assert after["log"]["mark"].tobytes() == before["log"]["mark"].tobytes()
    assert not srv.pool.scrub().bad_locations
    assert bool(srv.pool.commit(new_cache,
                                dirty_pages=srv._dirty_pages(srv.pos)))


def test_step_hooks_and_metrics(served, tmp_path):
    srv = Server(served["cfg"], ProtectConfig(mode="mlpc", block_words=64),
                 served["zmesh"], batch=BATCH, max_len=MAX_LEN,
                 metrics_dir=str(tmp_path / "m"),
                 trace_dir=str(tmp_path / "t"), metrics_every=3,
                 device="cpu")
    srv.start(convert.params_to_port(served["np_params"], "cpu"))
    seen = []
    srv.add_step_hook(lambda s, out: seen.append(out["pos"]))
    srv.generate(torch.from_numpy(prompt(5, 4)), n_new=3)
    assert seen == list(range(6))
    assert (tmp_path / "m" / "server.prom").exists()
    assert (tmp_path / "t").is_dir()


def test_launch_serve_runs(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "qwen3-0.6b", "--device", "cpu",
                       "--batch", "4", "--prompt-len", "3",
                       "--new-tokens", "3", "--scrub-period", "2"]) == 0
    out = capsys.readouterr().out
    assert "generated (4, 3)" in out and "health: green" in out
