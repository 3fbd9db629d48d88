"""The deferred-epoch engine on a zone split over processes (window > 1):
the bulk engine at window 4 on the flat route (r = 1) and streamed (r =
3), and the patch engine (mode mlp, r = 3, its flush the xor_delta
patch), each Pool's zone split over W spawned CPU processes, W in {2, 4}
on the (8, 1) mesh and 2 on (4, 2).  The plans
(tests/_torch_procs_window_ref.py) run in-window commits, a staged abort
smashed on one process only, the boundary flush, a mid-window loss with
its window bound, scrubs, a scribble whose scrub collapses the window
and a clean one that regrows it, patch commits naming words past their
leaf and a footprint past `dirty_capacity` refused on every process.
After every phase each process's slice of every field — the protected
state, `acc`, `dirty`, `pending`, the live row and the mirrored window
meta — is byte-equal to the reference's Pool and the one-process port's,
and its reports and window cadence are theirs.  Also: the window-meta
collectives (`meta_all_gather`, `xor_tree_reduce`, `make_meta_mirror`)
across processes against one process's."""
import pytest
import torch

from repro_torch.dist import collectives as coll
from repro_torch.dist import procs
from tests import _torch_procs_window_worker as worker
from tests._torch_procs_window_ref import cadence, run_case
from tests._torch_ref import as_words, rand_u32
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SPLITS = [("mesh81", 2), ("mesh81", 4), ("mesh42", 2)]


@pytest.fixture(scope="module")
def ref_cache():
    return {}


@pytest.mark.parametrize("mesh_name,world", SPLITS)
def test_split_window_is_byte_equal(mesh_name, world, tmp_path, ref_cache):
    one = run_case(mesh_name, world, ("bulk_r1", "bulk_r3", "patch_r3"),
                   tmp_path, ref_cache)
    # what the plans exercise, as every process saw it too
    for name in ("bulk_r1", "bulk_r3"):
        recs = one[name]
        assert [w for _, w, _ in cadence(recs)] == [4] * 6 + [1, 2, 1, 1, 2]
        assert [s for _, _, s in cadence(recs)][:6] == [0, 1, 2, 3, 0, 2]
        assert recs["staged_abort"]["report"]["verdicts"] == [False]
        assert recs["mid_window_loss"]["report"]["recover"][
            "window_bound"] == {"pending": 2, "dirty_pages": None,
                                "digest_verified": True}
        assert recs["scribble_collapse"]["report"]["scrub"][0]["repaired"]
    recs = one["patch_r3"]
    assert recs["staged_abort"]["report"]["verdicts"] == [False]
    assert "past the 2" in recs["refused"]["report"]["refused"]
    assert [s for _, _, s in cadence(recs)][:6] == [0, 1, 2, 3, 3, 0]
    assert recs["rank_loss"]["report"]["recover"]["window_bound"][
        "digest_verified"]


@pytest.mark.parametrize("shape,world", [((8, 1), 2), ((8, 1), 4),
                                         ((4, 2), 2)])
def test_meta_collectives_across_processes(shape, world):
    """Each process's block of the gathered table and of the tree reduce
    is one process's; the mirror holds the whole zone's table on every
    process, a 0-d entry copied and None passed through."""
    x = as_words(rand_u32(shape + (3,), seed=5))
    gather = coll.meta_all_gather(x, 0, len(shape))
    tree = coll.xor_tree_reduce(x, 0)
    gl = shape[0] // world
    out = procs.spawn_zone(worker.meta_worker, world, x.numpy(), 0,
                           len(shape), timeout=120)
    for rank, got in enumerate(out):
        block = slice(rank * gl, (rank + 1) * gl)
        assert torch.equal(torch.from_numpy(got["gather"]), gather[block])
        assert torch.equal(torch.from_numpy(got["tree"]), tree[block])
        assert torch.equal(torch.from_numpy(got["mirror"]), x)
        assert got["step"] == 7 and got["mirror_none"]
