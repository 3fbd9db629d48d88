"""The port's deferred-epoch engine against the reference's, step by step.

`EpochPair` drives the reference `DeferredProtector` and the port's in
lockstep on the same numpy inputs; after every commit and flush the whole
window is byte-equal: stack, checksums, digest, row, redo log, state, the
bulk engine's accumulator, the patch engine's dirty mask and the pending
count (and so, at every epoch boundary, what the synchronous engine
holds: the reference's own tests pin that)."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import layout as ref_layout
from repro.core.scrub import Scrubber as RefScrubber
from repro_torch import convert
from repro_torch.core import layout
from repro_torch.core.scrub import Scrubber
from tests._torch_ref import (EpochPair, epoch_fields, patched, state_like,
                              to_jax)
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _bulk_steps(ep, n, seed0=0):
    for i in range(n):
        assert ep.commit(state_like(seed0 + i, ep.cur), seed=seed0 + i)


@pytest.mark.parametrize("mesh_name,mode,r,streamed", [
    ("mesh42", "mlpc", 1, False), ("mesh42", "mlpc", 1, True),
    ("mesh81", "mlp", 1, False), ("mesh42", "mlpc", 2, True),
    ("mesh42", "mlp", 2, False), ("mesh81", "mlpc", 3, False),
    ("mesh42", "mlp", 3, True)])
def test_bulk_engine_matches_reference(mesh_name, mode, r, streamed):
    """Two windows of four whole-state commits: the accumulate sweep (flat,
    or streamed with the kernel's digest) every step, the weighted
    accumulator folded into the stack at each boundary."""
    kw = dict(stream_threshold_words=1, stream_chunk_words=128) \
        if streamed else {}
    ep = EpochPair(mesh_name, mode, window=4, redundancy=r, **kw)
    assert (ep.pair.port.stream_chunk() is not None) == streamed
    _bulk_steps(ep, 8)
    assert ep.port._since == 0 and not ep.port.needs_flush
    _bulk_steps(ep, 2, seed0=20)
    ep.flush()                            # a boundary off the cadence


def decode_state():
    """A decode step's state: a bf16 cache of 8 time slots whose slots are
    not word-aligned (21 values a device: each slot's words overhang into
    the next), a position scalar and an f32 weight, the row's last leaf.
    Leaves in row order: cache, pos, w."""
    rng = np.random.default_rng(5)
    return ({"cache": np.asarray(jnp.asarray(rng.standard_normal((8, 42)),
                                             jnp.bfloat16)),
             "pos": np.float32(0.0),
             "w": rng.standard_normal((8, 64)).astype(np.float32)},
            {"cache": (None, "model"), "pos": (), "w": ("data", "model")})


def _slot_words(ep, pos):
    """The reference's `time_slice_words` of cache slot `pos`."""
    return ref_layout.time_slice_words(ep.ref.p.layout, 8, pos)[0]


def _slot_step(cur, pos, seed):
    """Write cache slot `pos` (every model shard) and the position."""
    cache = np.asarray(cur["cache"]).copy()
    cache[pos] = np.asarray(jnp.asarray(
        np.random.default_rng(seed).standard_normal(42), jnp.bfloat16))
    return patched(cur, cache=cache, pos=np.float32(pos))


@pytest.mark.parametrize("mesh_name,mode,r,words,flush_patch", [
    ("mesh42", "mlpc", 1, "whole", False),     # the flush rebuilds
    ("mesh81", "mlpc", 2, "time", True),       # fused_commit_s
    ("mesh81", "mlp", 1, "time", True),        # xor_delta
    ("mesh81", "mlp", 3, "whole", True),       # xor_delta + sdelta_stack
    ("mesh42", "mlpc", 3, "time", False)])
def test_patch_engine_matches_reference(mesh_name, mode, r, words,
                                        flush_patch):
    """Decode commits against the static dirty leaves (cache, pos): whole
    leaves, or the word indices of one time slot (overhang included);
    both flush branches (cache + pos bound 5 of mesh81's 8 pages with
    spill, all 4 of mesh42's; hybrid threshold 0.95)."""
    ep = EpochPair(mesh_name, mode, window=3, dirty_leaf_idx=[0, 1],
                   redundancy=r, state=decode_state(),
                   hybrid_threshold=0.95)
    assert ep.port.flush_patch == ep.ref.flush_patch == flush_patch
    for i in range(6):
        pos = (3 * i + 1) % 8
        dw = None if words == "whole" else (_slot_words(ep, pos), None)
        assert ep.commit(_slot_step(ep.cur, pos, seed=i), seed=i,
                         dirty_words=dw)


def test_out_of_range_word_indices_read_zero_and_set_no_page():
    """Word indices at or past a leaf's end read 0 from both sides (the
    reference's fill gather); those whose page lies past the row end set
    no page (its dropped scatter).  w is the row's last leaf; slot 7's
    overhang runs past the cache's end."""
    ep = EpochPair("mesh42", "mlpc", window=2, dirty_leaf_idx=[0, 2],
                   state=decode_state())
    lo = ep.port.p.layout
    n_w = lo.slots[2].n_words
    assert (lo.slots[2].offset + n_w + 200) // 64 >= lo.n_blocks
    assert _slot_words(ep, 7).max() >= lo.slots[0].n_words
    for i, pos in enumerate((7, 2, 7, 5)):
        new = _slot_step(ep.cur, pos, seed=i)
        w = np.asarray(new["w"]).copy()
        # local words 0-2 of every rank: the first row of each (2, 32) shard
        w[0::2, [0, 1, 2, 32, 33, 34]] += 1.0
        w_words = np.array([0, 1, 2, n_w, n_w + 3, n_w + 200, 10**6],
                           np.int32)
        assert ep.commit(patched(new, w=w, pos=np.float32(ep.cur["pos"])),
                         seed=i, dirty_words=(_slot_words(ep, pos), w_words))


def test_flush_patches_last_page_despite_fill_slots():
    """The reference's regression: the flush's fill slots go to the
    sentinel, not the clamped last page, so a dirty last page keeps its
    patch.  Leaf z is one word in the row's last page."""
    state = ({"a": np.arange(4 * 192, dtype=np.float32),
              "z": np.float32(1.5)}, {"a": ("data",), "z": ()})
    ep = EpochPair("mesh42", "mlpc", window=2, dirty_leaf_idx=[1],
                   hybrid_threshold=0.95, state=state)
    lo = ep.port.p.layout
    assert layout.leaf_pages(lo, 1).tolist() == [lo.n_blocks - 1]
    assert ep.port.flush_patch and ep.port.flush_capacity > 1
    for i in range(2):
        assert ep.commit(patched(ep.cur, z=np.float32(ep.cur["z"] * 2 + 1)),
                         seed=40 + i)


@pytest.mark.parametrize("kf", [1, 3, 5, 8])
def test_dirty_slot_compaction_matches_nonzero_with_fill(kf):
    """The flush's page list: the reference's `jnp.nonzero(mask, size=kf,
    fill_value=nb)`, the fill slots at the sentinel nb (never the clamped
    last page, which a dirty last page would collide with)."""
    import torch
    from repro_torch.core.epoch import dirty_slots
    rng = np.random.default_rng(kf)
    for mask in (rng.random(8) < 0.4, np.zeros(8, bool), np.ones(8, bool),
                 np.eye(8, dtype=bool)[7]):
        idx, valid = dirty_slots(torch.from_numpy(mask), kf)
        want = np.asarray(jnp.nonzero(jnp.asarray(mask), size=kf,
                                      fill_value=8)[0])
        np.testing.assert_array_equal(idx.numpy(), want)
        np.testing.assert_array_equal(valid.numpy(), want < 8)


@pytest.mark.parametrize("patch", [False, True])
def test_abort_mid_window_leaves_window_intact(patch):
    """An abort is a no-op on the window (log included) that still counts
    as an attempt toward the cadence."""
    ep = EpochPair("mesh42", "mlpc", window=3,
                   dirty_leaf_idx=[0, 1] if patch else None,
                   state=decode_state() if patch else None)
    step = (lambda i: _slot_step(ep.cur, i, seed=i)) if patch else \
        (lambda i: state_like(i, ep.cur))
    assert ep.commit(step(0), seed=0)
    before = convert.from_port_epoch(ep.pest)
    assert not ep.commit(step(1), seed=1, canary_ok=False)
    after = convert.from_port_epoch(ep.pest)
    for k in ("row", "digest", "cksums", "step"):
        assert after["prot"][k].tobytes() == before["prot"][k].tobytes()
    assert after["prot"]["log"]["mark"].tobytes() == \
        before["prot"]["log"]["mark"].tobytes()
    assert int(ep.pest.pending) == 1 and ep.port._since == 2
    assert ep.commit(step(2), seed=2)         # third attempt: the boundary
    assert not ep.port.needs_flush


def test_mid_window_scribble_detected_after_flush():
    """A scribble on the live state mid-window is caught by the first
    scrub after the flush, and repaired to the intended values."""
    ep = EpochPair("mesh42", "mlpc", window=4)
    _bulk_steps(ep, 2)
    intended = epoch_fields(ep.rest, ep.pair.mesh)["prot"]["state"]["w1"]
    from repro.runtime import failure as ref_failure
    from repro_torch.runtime import failure
    rp, _ = ref_failure.inject_scribble(ep.pair.ref, ep.rest.prot, rank=1,
                                        word_offsets=[7])
    pp, _ = failure.inject_scribble(ep.pair.port, ep.pest.prot, rank=1,
                                    word_offsets=[7])
    ep.rest.prot, ep.pest.prot = rp, pp
    ep.flush()
    rprot, rrep = RefScrubber(ep.pair.ref, period=1).run(ep.rest.prot)
    pprot, prep = Scrubber(ep.pair.port, period=1).run(ep.pest.prot)
    assert prep.bad_locations == rrep.bad_locations != []
    assert prep.repair_ok and rrep.repair_ok
    assert prep.row_cache_ok is False and rrep.row_cache_ok is False
    got = convert.from_port(pprot)["state"]["w1"]
    assert got.tobytes() == intended.tobytes()


def test_report_pressure_collapses_and_regrows_the_window():
    """A suspect signal collapses the window to 1 from the next commit on;
    clean signals double it back to the ceiling; both engines agree at
    every step."""
    ep = EpochPair("mesh42", "mlpc", window=4, redundancy=2)
    _bulk_steps(ep, 2)
    assert ep.ref.report_pressure(True) == ep.port.report_pressure(True) == 1
    _bulk_steps(ep, 2, seed0=10)              # the first flushes the window
    assert ep.ref.report_pressure(False) == ep.port.report_pressure(False) \
        == 2
    _bulk_steps(ep, 3, seed0=20)
    assert ep.ref.report_pressure(False) == ep.port.report_pressure(False) \
        == 4
    _bulk_steps(ep, 4, seed0=30)


def test_window_meta_and_bound_match_reference():
    """The mirrored window metadata (step, pending, digest, dirty pages)
    and the window bound after a flush."""
    ep = EpochPair("mesh81", "mlpc", window=4, dirty_leaf_idx=[0, 1],
                   replicate_meta=True, state=decode_state())
    assert ep.port.window_meta is None
    for i in range(2):
        assert ep.commit(_slot_step(ep.cur, i, seed=i), seed=i,
                         dirty_words=(_slot_words(ep, i), None))
    want, got = ep.ref.window_meta, ep.port.window_meta
    assert got["dirty_pages"] == want["dirty_pages"] != []
    assert (got["step"], got["pending"]) == (want["step"], want["pending"])
    assert got["digest"].tobytes() == np.asarray(want["digest"]).tobytes()
    ep.flush()
    assert ep.port.verify_window_bound(ep.pest) is True
    assert ep.ref.verify_window_bound(ep.rest) is True


@pytest.mark.parametrize("patch", [False, True])
def test_reference_window_carried_into_the_port(patch):
    """A window opened in the reference (two commits) crosses into the
    port with `convert.to_port_epoch`; both finish it byte-equal."""
    ep = EpochPair("mesh81" if patch else "mesh42", "mlp" if patch else
                   "mlpc", window=4, redundancy=2,
                   dirty_leaf_idx=[0, 1] if patch else None,
                   state=decode_state() if patch else None,
                   hybrid_threshold=0.95)
    assert ep.port.flush_patch == patch
    pr = ep.pair

    def step(i):
        return _slot_step(ep.cur, i, seed=i) if patch else \
            state_like(i, ep.cur)
    for i in range(2):
        new = step(i)
        ep.rest, _ = ep.ref.commit(ep.rest, to_jax(new, pr.specs, pr.mesh),
                                   data_cursor=i + 1)
        pr.cur = new
    ep.pest = ep.port.resume(convert.to_port_epoch(
        epoch_fields(ep.rest, pr.mesh), device="cpu"))
    ep.check()
    for i in range(2, 4):
        assert ep.commit(step(i), seed=i)
    assert not ep.port.needs_flush
