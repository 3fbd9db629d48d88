"""The hybrid server against the reference's on the (8, 1) mesh, where
the K/V rings keep their whole sequence a rank and every decode commit
is a patch: tests/test_torch_hybrid_runtime.py's check (its served model
and fixture) at r {1, 3} x window {1, 4}, in a file of its own so that
each file runs in about a minute.
"""
import pytest

from tests.test_torch_hybrid_runtime import check_server, served  # noqa: F401
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("r", [1, 3])
def test_server_matches_the_reference_on_the_wide_mesh(served, r, window):
    check_server(served, "mesh81", r, window)
