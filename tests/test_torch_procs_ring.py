"""The async commit ring on a zone split over processes (pipeline_depth >
1): depth 4 on the synchronous r = 3 engine (a verified bulk, a staged
abort smashed on one process only, a patch with an owner on every rank,
a poll and a drain, three tickets in flight through a three-rank loss)
and depth 3 on the r = 1 bulk engine at window 4 (a staged abort inside
the window, a polled window, two tickets in flight through a mid-window
loss), each Pool's zone split over W spawned CPU processes, W in {2, 4}
on the (8, 1) mesh and 2 on (4, 2).  After every phase each process's
slice of every field and of the open window is byte-equal to the
reference's Pool and the one-process port's, and its verdicts, reports
and window cadence are theirs; the one-process drained state is the one
at depth 1 (tests/_torch_procs_window_ref.py)."""
import pytest

from tests._torch_procs_window_ref import cadence, run_case
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def ref_cache():
    return {}


@pytest.mark.parametrize("mesh_name,world", [
    ("mesh81", 2), ("mesh81", 4), ("mesh42", 2)])
def test_split_ring_is_byte_equal(mesh_name, world, tmp_path, ref_cache):
    one = run_case(mesh_name, world, ("ring_sync_r3", "ring_window_r1"),
                   tmp_path, ref_cache, depth_1=True)
    sync, win = one["ring_sync_r3"], one["ring_window_r1"]
    assert sync["dispatch_poll_drain"]["report"]["verdicts"] == [
        True, True, False, True, True]
    assert sync["loss_in_flight"]["report"]["verdicts"] == [True] * 3
    assert win["window_1"]["report"]["verdicts"] == [True, True, False,
                                                     True]
    assert [s for _, _, s in cadence(win)] == [0, 0, 0, 0, 0]
    assert win["loss_in_flight"]["report"]["recover"]["window_bound"][
        "pending"] == 2
