"""The plain versions of the streamed fused syndrome sweeps
(`fused_commit_s_stream`, `fused_verify_commit_s_stream`: the flat sweep
plus each rank's row digest) against the reference's Pallas kernels run in
interpret mode AND its kernels/ref.py oracles, byte for byte, at r = 2, 3
and 4."""
import pytest

from repro.kernels import gf_parity as ref_gp
from repro.kernels import ref
from repro_torch.kernels import ops
from tests._torch_ref import GF_SHAPES, check_outputs, sweep_inputs
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("n,bw", GF_SHAPES)
@pytest.mark.parametrize("r", [2, 3, 4])
def test_streamed_syndrome_sweeps_plain_vs_pallas_and_ref(r, n, bw):
    (to, tn, ts, tc), (jo, jn, js, jc) = sweep_inputs(r, n, bw)
    check_outputs(ops.fused_commit_s_stream(to, tn, tc),
                  ref_gp.fused_commit_s_stream(jo, jn, jc, chunk_blocks=4,
                                               interpret=True),
                  ref.fused_commit_s_stream_ref(jo, jn, jc))
    check_outputs(
        ops.fused_verify_commit_s_stream(to, tn, ts, tc),
        ref_gp.fused_verify_commit_s_stream(jo, jn, js, jc, chunk_blocks=4,
                                            interpret=True),
        ref.fused_verify_commit_s_stream_ref(jo, jn, js, jc))
