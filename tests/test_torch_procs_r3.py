"""The multi-process zone backend at r = 3: tests/test_torch_procs.py's
phase sequence with a three-plane syndrome stack and a three-rank loss
(ranks 0, G/2 and G-1, on the first and last processes) between the rank
loss and the scribble, W in {2, 4} on the (8, 1) mesh and 2 on (4, 2).
Each process's slice of every field is byte-equal to the reference's and
to the one-process port's after every phase (tests/_torch_procs_ref.py);
the over-budget loss names four ranks."""
import pytest

from tests._torch_procs_ref import run_case
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def ref_cache():
    return {}


@pytest.mark.parametrize("mesh_name,world", [
    ("mesh81", 2), ("mesh81", 4), ("mesh42", 2)])
def test_split_zone_is_byte_equal_at_r3(mesh_name, world, tmp_path,
                                        ref_cache):
    run_case(mesh_name, 3, world, tmp_path, ref_cache)
