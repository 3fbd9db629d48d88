"""The multi-process zone backend at r = 1 (dist/procs.py and the split
`ZoneMesh`): the synchronous engine behind `Pool` with its zone split over
W spawned CPU processes, W in {2, 4} on the (8, 1) mesh and 2 on (4, 2).
After every phase — open, bulk with and without verify_old, patch with
and without it (a page owned by every rank), scrub, pre-check, rank loss,
a scribble repaired by the scrub, a flipped word found by the pre-check
and repaired, a canary smashed on one process only, an over-budget loss
— each process's slice of every field is byte-equal to the reference's
and to the one-process port's, and its reports are theirs
(tests/_torch_procs_ref.py).  Also: `spawn_zone` raises for a worker that
raises, a collective that hangs past its timeout and a worker that
outlives the spawn's; what a split mesh runs and the refusals that stay;
and the exchange's
bytes in the cost counter, where one process reports none."""
import pytest

from repro_torch import ZoneMesh
from repro_torch.dist import procs
from repro_torch.kernels import cost as kcost
from tests import _torch_procs_worker as worker
from tests._torch_procs_ref import run_case
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def ref_cache():
    return {}


@pytest.mark.parametrize("mesh_name,world", [
    ("mesh81", 2), ("mesh81", 4), ("mesh42", 2)])
def test_split_zone_is_byte_equal_at_r1(mesh_name, world, tmp_path,
                                        ref_cache):
    run_case(mesh_name, 1, world, tmp_path, ref_cache)


@pytest.mark.parametrize("kind,match", [
    ("raises", "(?s)worker 1 raised:.*planted failure"),
    ("hangs", "(?s)worker 0 raised:.*(Timed out|timeout|timed out)"),
    ("sleeps", "still running after 4 s")])
def test_spawn_zone_raises_for_a_failed_or_hung_worker(kind, match):
    """A worker that raises, a collective whose peer never comes (it
    times out after the group's 3 s and raises), and a worker that sleeps
    past the spawn's own 4 s: each makes `spawn_zone` raise, with every
    worker stopped."""
    with pytest.raises(procs.ZoneError, match=match):
        procs.spawn_zone(worker.failing_worker, 2, kind, timeout=4.0 if
                         kind == "sleeps" else 60.0, group_timeout=3.0)


def test_split_mesh_refusals():
    """On a split mesh the deferred engine, the ring, a staged canary,
    PoolGroup, a rescale and a reshard onto a mesh split over the same
    group, a PoolGroup rescale that changes the process count (2 -> 1 of
    the two), a Server and a Trainer run; what stays refused raises, each
    by its message: a rescale or a PoolGroup rescale onto a one-process
    mesh (no common parent group), a batch that G does not divide (`batch
    % G`), microbatches that W does not divide (`microbatches % W`), and a
    W that does not divide G."""
    out = procs.spawn_zone(worker.refusal_worker, 2, timeout=120)
    for got in out:
        for what in ("window", "pipeline_depth", "staged_canary",
                     "deferred", "pool_group", "rescale", "reshard",
                     "pool_group_regroup", "server", "trainer"):
            assert got[what] is None, (what, got[what])
        for what, kind, match in (
                ("rescale_regroup", "NotImplementedError",
                 "from a zone on 2 process(es) to one on 1 whose meshes "
                 "have no common parent group"),
                ("pool_group_one_process", "NotImplementedError",
                 "from a zone on 2 process(es) to one on 1 whose meshes "
                 "have no common parent group"),
                ("server_batch", "ValueError", "batch % G = 2 % 4 = 2"),
                ("trainer_microbatches", "ValueError",
                 "microbatches % W = 1 % 2 = 1"),
                ("indivisible", "ValueError", "do not split a zone of 3")):
            assert got[what] is not None, what
            assert got[what][0] == kind, (what, got[what])
            assert match in got[what][1], (what, got[what])
            assert "S7c" not in got[what][1], (what, got[what])


def test_nccl_is_refused(monkeypatch):
    """A process group whose backend is NCCL holds no split zone (it is
    refused before anything reads it)."""
    monkeypatch.setattr(procs.dist, "get_backend", lambda pg: "nccl")
    with pytest.raises(ValueError, match="a nccl process group.*gloo"):
        ZoneMesh((4, 1), ("data", "model"), group=object())


def test_exchange_bytes_in_the_cost_counter():
    """One process reports the reference-convention kinds only; a split
    zone's processes report the same kinds over their half of the ranks
    and the bytes they sent, as `process-exchange`, equal to what their
    group counted."""
    one, sent = worker.commit_wire(ZoneMesh((4, 1), ("data", "model")))
    assert kcost.EXCHANGE not in one and sent == 0
    for got in procs.spawn_zone(worker.wire_worker, 2, timeout=120):
        kinds, sent = got
        assert kinds[kcost.EXCHANGE] == sent > 0
        assert {k: v * 2 for k, v in kinds.items()
                if k != kcost.EXCHANGE} == one
