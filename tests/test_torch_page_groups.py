"""The page-run sweeps (`fletcher_pages`, `syndrome_pages`; csrc/pages.cuh)
in their plain PyTorch mirrors, byte for byte.

A CTA of those kernels takes a run of K = `fletcher.RUN_PAGES` pages of one
rank (the rank's last run shorter) and adds the run's digest partials into
the rank's digest once.  `fletcher.run_digest_plain` forms the digest that
way — each rank's pages cut into runs of K, each run's shares (A, B +
(n - 1 - local)·bw·A) summed, the runs' sums combined — and
`gf_parity.syndrome_runs_plain` the whole syndrome sweep as the kernel
does, the weighted planes by the table multiply (`table_mul_plain` over
the delta, plane 0 raw).  Both are held against `checksum.combine`, the
port's plain versions and the reference's `fletcher_stream`,
`fused_commit_s`, `fused_verify_commit_s` and `fused_verify_commit_s_stream`
— its Pallas kernels in interpret mode AND its kernels/ref.py oracles —
for n = 1, K - 1, K, K + 1, 2K + 3 and 16 pages at leads 1 and 3, at
r = 2 and 3.  Inputs are numpy-seeded.  The CUDA kernels are held against
the port's plain versions on the card (test_torch_cuda.py,
chip_smoke.py)."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gf as ref_gf
from repro.kernels import fletcher as ref_fl
from repro.kernels import gf_parity as ref_gp
from repro.kernels import ref
from repro_torch.core import checksum
from repro_torch.kernels import fletcher as fl
from repro_torch.kernels import gf_parity as gfk
from tests._torch_ref import as_words, check_outputs, rand_u32, words
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

K = fl.RUN_PAGES
NS = [1, K - 1, K, K + 1, 2 * K + 3, 16]
BW = 64
CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")


def test_run_pages_is_the_kernels():
    """The mirrors cut runs as the kernels do: RUN_PAGES is pages.cuh's
    kRunPages, which both page-run kernels take."""
    found = re.findall(r"constexpr int kRunPages = (\d+);",
                       (CSRC / "pages.cuh").read_text())
    assert found == [str(K)]
    for source in ("fletcher.cu", "gf_parity.cu"):
        text = (CSRC / source).read_text()
        assert "pages::page_run(" in text and "kRunPages =" not in text


def _inputs(lead, n, r, seed):
    """Seeded (old, new, stored, coefficients) of `lead` ranks of a zone of
    100 (its last ranks), `stored` the old pages' terms with a few rows
    corrupted; numpy arrays."""
    old = rand_u32((lead, n, BW), seed)
    new = rand_u32((lead, n, BW), seed + 1)
    stored = words(fl.fletcher_pages_plain(as_words(old))).copy()
    stored[:, ::3, 1] ^= 1
    coeffs = ref_gf.syndrome_array(100, r)[100 - lead:]
    return old, new, stored, coeffs


@pytest.mark.parametrize("lead", [1, 3])
@pytest.mark.parametrize("n", NS)
def test_run_digest_matches_combine_and_reference(n, lead):
    x = rand_u32((lead, n, BW), seed=n + 7 * lead)
    terms = fl.fletcher_pages_plain(as_words(x))
    got = fl.run_digest_plain(terms, BW)
    assert got.shape == (lead, 2)
    _, plain_dig = fl.fletcher_stream_plain(as_words(x))
    assert torch.equal(got, checksum.combine(terms, BW))
    assert torch.equal(got, plain_dig)
    for i in range(lead):
        jx = jnp.asarray(x[i])
        p_terms, p_dig = ref_fl.fletcher_stream(jx, chunk_blocks=4,
                                                interpret=True)
        r_terms, r_dig = ref.fletcher_stream_ref(jx)
        check_outputs((terms[i], got[i]), (p_terms, p_dig), (r_terms, r_dig))


@pytest.mark.parametrize("run_pages", [1, 2, 3, K, 4 * K])
def test_run_digest_any_run_length(run_pages):
    """The digest does not depend on where the runs are cut."""
    terms = as_words(rand_u32((3, 2 * K + 3, 2), seed=run_pages))
    assert np.array_equal(words(fl.run_digest_plain(terms, BW, run_pages)),
                          words(checksum.combine(terms, BW)))


@pytest.mark.parametrize("lead", [1, 3])
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("r", [2, 3])
def test_syndrome_runs_match_plain_and_reference(r, n, lead):
    old, new, stored, coeffs = _inputs(lead, n, r, seed=100 * r + 3 * n + lead)
    to, tn, ts, tc = (as_words(a) for a in (old, new, stored, coeffs))
    got = gfk.syndrome_runs_plain(to, tn, tc, ts, digest=True)
    want = gfk.syndrome_pages_plain(to, tn, tc, ts, digest=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
    flat = gfk.syndrome_runs_plain(to, tn, tc)
    assert flat[2] is None and flat[3] is None
    assert torch.equal(flat[0], got[0]) and torch.equal(flat[1], got[1])
    sdelta, terms, mism, dig = got
    bad = (mism != 0).any(-1)
    for i in range(lead):
        jo, jn, js, jc = (jnp.asarray(a[i]) for a in (old, new, stored,
                                                      coeffs))
        check_outputs(
            (sdelta[i], terms[i], bad[i], dig[i]),
            ref_gp.fused_verify_commit_s_stream(jo, jn, js, jc,
                                                chunk_blocks=4,
                                                interpret=True),
            ref.fused_verify_commit_s_stream_ref(jo, jn, js, jc))
        check_outputs((sdelta[i], terms[i], bad[i]),
                      ref_gp.fused_verify_commit_s(jo, jn, js, jc,
                                                   interpret=True),
                      ref.fused_verify_commit_s_ref(jo, jn, js, jc))
        check_outputs((sdelta[i], terms[i]),
                      ref_gp.fused_commit_s(jo, jn, jc, interpret=True),
                      ref.fused_commit_s_ref(jo, jn, jc))


@pytest.mark.parametrize("r", [2, 3, 4])
def test_syndrome_runs_coefficients_zero_and_one(r):
    """A coefficient table holding 0 and 1, as chip_smoke's edge cases
    give the kernel: the table multiply's planes are 0 and the raw delta
    there."""
    old, new, stored, coeffs = _inputs(3, K + 1, r, seed=r)
    tc = as_words(coeffs).clone()
    tc[0, 1] = 0
    tc[-1, -1] = 1
    to, tn, ts = as_words(old), as_words(new), as_words(stored)
    got = gfk.syndrome_runs_plain(to, tn, tc, ts, digest=True)
    want = gfk.syndrome_pages_plain(to, tn, tc, ts, digest=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
    assert not got[0][0, 1].any()
    assert np.array_equal(words(got[0][-1, -1]), old[-1] ^ new[-1])
