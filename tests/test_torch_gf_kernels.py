"""The plain versions of the flat fused syndrome sweeps (the CPU path of
kernels/ops.py's `fused_commit_s`, `fused_verify_commit_s` and
`fused_commit_old_terms_s`) against the reference's Pallas kernels run in
interpret mode AND its kernels/ref.py oracles, byte for byte, at r = 2, 3
and 4; the zone-stacked call with per-rank coefficient rows against one
reference call per rank; and the r = 1 routes (no coefficients) against
the single-parity family.  The streamed sweeps are in
test_torch_gf_stream.py."""
import jax.numpy as jnp
import pytest
import torch

from repro.core import gf as ref_gf
from repro.kernels import gf_parity as ref_gp
from repro.kernels import ref
from repro_torch.core import gf
from repro_torch.dist.sharding import ZoneMesh
from repro_torch.kernels import ops
from tests._torch_ref import (GF_SHAPES, as_words, check_outputs, eq_words,
                              rand_u32, sweep_inputs, sweep_pages)
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("n,bw", GF_SHAPES)
@pytest.mark.parametrize("r", [2, 3, 4])
def test_flat_syndrome_sweeps_plain_vs_pallas_and_ref(r, n, bw):
    (to, tn, ts, tc), (jo, jn, js, jc) = sweep_inputs(r, n, bw)
    check_outputs(ops.fused_commit_s(to, tn, tc),
                  ref_gp.fused_commit_s(jo, jn, jc, interpret=True),
                  ref.fused_commit_s_ref(jo, jn, jc))
    check_outputs(ops.fused_verify_commit_s(to, tn, ts, tc),
                  ref_gp.fused_verify_commit_s(jo, jn, js, jc,
                                               interpret=True),
                  ref.fused_verify_commit_s_ref(jo, jn, js, jc))
    check_outputs(ops.fused_commit_old_terms_s(to, tn, tc),
                  ref_gp.fused_commit_old_terms_s(jo, jn, jc,
                                                  interpret=True),
                  ref.fused_commit_old_terms_s_ref(jo, jn, jc))


def test_zone_stacked_sweep_equals_per_rank_calls():
    """`(G, M, n, bw)` pages with each rank's own coefficient row in one
    call == one reference call per rank: planes `(G, M, r, n, bw)`, terms,
    verdicts and each rank's digest over its own pages only."""
    g, m, n, bw, r = 5, 2, 3, 64, 3
    old, new = rand_u32((g, m, n, bw), 1), rand_u32((g, m, n, bw), 2)
    stored = rand_u32((g, m, n, 2), 3)
    table = gf.rank_syndrome_coeffs(g, r, ZoneMesh((g, m), ("data", "x")),
                                    "cpu")
    got = ops.fused_verify_commit_s_stream(as_words(old), as_words(new),
                                           as_words(stored), table)
    old_t = ops.fused_commit_old_terms_s(as_words(old), as_words(new), table)
    assert got[0].shape == (g, m, r, n, bw)
    for i in range(g):
        co = jnp.asarray(ref_gf.syndrome_array(g, r)[i])
        for j in range(m):
            jo, jn, js = (jnp.asarray(old[i, j]), jnp.asarray(new[i, j]),
                          jnp.asarray(stored[i, j]))
            for out, want in zip(
                    got, ref.fused_verify_commit_s_stream_ref(jo, jn, js,
                                                              co)):
                eq_words(out[i, j], want)
            for out, want in zip(old_t,
                                 ref.fused_commit_old_terms_s_ref(jo, jn,
                                                                  co)):
                eq_words(out[i, j], want)


def test_r1_routes_to_the_single_parity_family():
    """No coefficients = r = 1: the delta as the only plane, as the
    reference's ops.py:113-150 routes it."""
    old, new, stored = sweep_pages(8, 64, seed=5)
    to, tn, ts = as_words(old), as_words(new), as_words(stored)
    pairs = [(ops.fused_commit_s(to, tn), ops.fused_commit(to, tn)),
             (ops.fused_verify_commit_s(to, tn, ts),
              ops.fused_verify_commit(to, tn, ts)),
             (ops.fused_commit_old_terms_s(to, tn),
              ops.fused_commit_old_terms(to, tn)),
             (ops.fused_commit_s_stream(to, tn),
              ops.fused_commit_stream(to, tn)),
             (ops.fused_verify_commit_s_stream(to, tn, ts),
              ops.fused_verify_commit_stream(to, tn, ts))]
    for stacked, flat in pairs:
        assert stacked[0].shape == (1, 8, 64)
        assert torch.equal(stacked[0][0], flat[0])
        for a, b in zip(stacked[1:], flat[1:], strict=True):
            assert torch.equal(a, b)
