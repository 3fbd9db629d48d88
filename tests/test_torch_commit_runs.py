"""commit_pages (csrc/commit_fused.cu) as page runs, in its plain PyTorch
mirror, byte for byte.

A CTA of the kernel takes a run of K = `fletcher.RUN_PAGES` pages of one
rank (the rank's last run shorter), a warp a page, as the other page-run
sweeps do, and adds the run's digest partials into the rank's digest once;
with a stored table it writes each page's verdict `bad` in the sweep, and
in its old-terms mode the old page's raw terms, reading no stored table.
`commit_fused.commit_runs_plain` forms all of that as the kernel does, and
is held against the port's `commit_pages_plain`, `checksum.combine` and
the reference's `fused_commit`, `fused_commit_stream`,
`fused_verify_commit`, `fused_verify_commit_stream`,
`fused_commit_old_terms`, `fused_commit_old_terms_stream`,
`fused_accum_commit` and `fused_accum_commit_stream` — its Pallas kernels
in interpret mode AND its kernels/ref.py oracles — for n = 1, K - 1, K,
K + 1, 2K + 3 and 16 pages at leads 1 and 3.  Inputs are numpy-seeded.
The CUDA kernel is held against the port's plain version on the card
(test_torch_cuda.py, chip_smoke.py's commit_edges)."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import commit_fused as ref_cf
from repro.kernels import ref
from repro_torch.core import checksum
from repro_torch.kernels import commit_fused as cf
from repro_torch.kernels import fletcher as fl
from repro_torch.kernels import ops
from tests._torch_ref import as_words, check_outputs, rand_u32, words
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

K = fl.RUN_PAGES
NS = [1, K - 1, K, K + 1, 2 * K + 3, 16]
BW = 64
CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
# entry point: (the mirror's mode, digest, the mirror's outputs in the
# reference's order)
ENTRIES = {
    "fused_commit": (None, False, (0, 1)),
    "fused_commit_stream": (None, True, (0, 1, 3)),
    "fused_verify_commit": ("stored", False, (0, 1, 2)),
    "fused_verify_commit_stream": ("stored", True, (0, 1, 2, 3)),
    "fused_commit_old_terms": ("old_terms", False, (0, 1, 2)),
    "fused_commit_old_terms_stream": ("old_terms", True, (0, 1, 2, 3)),
    "fused_accum_commit": ("acc", False, (0, 2, 1)),
    "fused_accum_commit_stream": ("acc", True, (0, 2, 1, 3)),
}


def _inputs(lead, n, seed):
    """Seeded (old, new, acc, stored) numpy arrays, `stored` the old pages'
    terms with B corrupted on every third page and A on every third page
    after the first."""
    old = rand_u32((lead, n, BW), seed)
    new = rand_u32((lead, n, BW), seed + 1)
    acc = rand_u32((lead, n, BW), seed + 2)
    stored = words(fl.fletcher_pages_plain(as_words(old))).copy()
    stored[:, ::3, 1] ^= 1
    stored[:, 1::3, 0] ^= 1 << 31
    return old, new, acc, stored


def _mode_kw(mode, acc, stored):
    return {None: {}, "stored": {"stored": stored},
            "old_terms": {"old_terms": True}, "acc": {"acc": acc}}[mode]


def test_run_constants_are_the_kernels():
    """The mirror cuts runs and names modes as the kernel does: it takes
    its runs through pages::page_run (RUN_PAGES is pages.cuh's kRunPages)
    and adds its digest through run_digest_add, one atomic pair a CTA; its
    modes are commit_fused.cu's Mode."""
    text = (CSRC / "commit_fused.cu").read_text()
    assert re.findall(r"constexpr int kRunPages = (\d+);",
                      (CSRC / "pages.cuh").read_text()) == [str(K)]
    modes = re.search(r"enum Mode : int \{([^}]*)\}", text).group(1)
    assert [(m, int(v)) for m, v in re.findall(r"k(\w+) = (\d+)", modes)] == [
        ("Commit", cf.COMMIT), ("Verify", cf.VERIFY),
        ("OldTerms", cf.OLD_TERMS), ("Accum", cf.ACCUM)]
    assert "pages::page_run(n, runs)" in text
    assert "pages::run_digest_add(" in text and "atomicAdd" not in text
    assert "kRunPages =" not in text


@pytest.mark.parametrize("lead", [1, 3])
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("run_pages", [1, 3, K])
def test_run_digest_matches_combine(run_pages, n, lead):
    """The digest summed run by run is checksum.combine's, wherever the
    runs are cut."""
    old, new, _, _ = _inputs(lead, n, seed=n + 7 * lead)
    to, tn = as_words(old), as_words(new)
    _, terms, _, dig = cf.commit_runs_plain(to, tn, digest=True,
                                            run_pages=run_pages)
    assert torch.equal(dig, checksum.combine(terms, BW))
    assert torch.equal(dig, cf.commit_pages_plain(to, tn, digest=True)[3])


@pytest.mark.parametrize("lead", [1, 3])
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_commit_runs_match_plain_and_reference(entry, n, lead):
    """The mirror against the plain version, the entry point on the CPU,
    and the reference's Pallas kernel in interpret mode and its ref.py
    oracle, rank by rank."""
    mode, digest, order = ENTRIES[entry]
    old, new, acc, stored = _inputs(lead, n, seed=1000 + 13 * n + lead)
    to, tn, ta, ts = (as_words(a) for a in (old, new, acc, stored))
    kw = dict(_mode_kw(mode, ta, ts), digest=digest)
    got = cf.commit_runs_plain(to, tn, **kw)
    want = cf.commit_pages_plain(to, tn, **kw)
    for a, b in zip(got, want, strict=True):
        assert (a is None and b is None) or torch.equal(a, b)
    if mode == "stored":
        assert got[2].dtype == torch.bool and got[2].shape == (lead, n)
    mine = [got[i] for i in order]
    args = {"stored": (to, tn, ts), "acc": (ta, to, tn)}.get(mode, (to, tn))
    check_outputs(mine, [words(x) if x.dtype == torch.int32 else x.numpy()
                         for x in getattr(ops, entry)(*args)])
    for i in range(lead):
        jo, jn, ja, js = (jnp.asarray(a[i]) for a in (old, new, acc, stored))
        jargs = {"stored": (jo, jn, js), "acc": (ja, jo, jn)}.get(mode,
                                                                  (jo, jn))
        extra = {"chunk_blocks": 4} if digest else {}
        check_outputs([m[i] for m in mine],
                      getattr(ref_cf, entry)(*jargs, interpret=True, **extra),
                      getattr(ref, entry + "_ref")(*jargs))


@pytest.mark.parametrize("flip", ["none", "a", "b", "both"])
def test_verdict_reads_both_terms(flip):
    """A page is bad where either stored term differs, and only there: the
    kernel's (A != stored A) | (B != stored B) against the reference's
    any(old terms != stored)."""
    old, new, _, _ = _inputs(3, 2 * K + 3, seed=7)
    stored = words(fl.fletcher_pages_plain(as_words(old))).copy()
    if flip in ("a", "both"):
        stored[:, ::2, 0] += 1
    if flip in ("b", "both"):
        stored[:, ::5, 1] ^= 1 << 17
    to, tn, ts = as_words(old), as_words(new), as_words(stored)
    bad = cf.commit_runs_plain(to, tn, ts)[2]
    assert torch.equal(bad, cf.commit_pages_plain(to, tn, ts)[2])
    assert bad.any().item() == (flip != "none")
    for i in range(3):
        want = ref.fused_verify_commit_ref(jnp.asarray(old[i]),
                                           jnp.asarray(new[i]),
                                           jnp.asarray(stored[i]))[2]
        np.testing.assert_array_equal(bad[i].numpy(), np.asarray(want))


def test_old_terms_mode_is_the_zero_stored_sweep():
    """The old-terms mode's raw old terms are what the reference's verify
    sweep with stored = 0 writes, and what the accumulate sweep writes."""
    old, new, acc, _ = _inputs(3, K + 1, seed=11)
    to, tn, ta = as_words(old), as_words(new), as_words(acc)
    olds = cf.commit_runs_plain(to, tn, old_terms=True)[2]
    assert torch.equal(olds, fl.fletcher_pages_plain(to))
    assert torch.equal(olds, cf.commit_runs_plain(to, tn, acc=ta)[2])
    for i in range(3):
        _, _, mism = ref_cf.fused_commit_old_terms(
            jnp.asarray(old[i]), jnp.asarray(new[i]), interpret=True)
        np.testing.assert_array_equal(words(olds[i]), np.asarray(mism))


def test_modes_are_exclusive():
    """One of stored, old_terms and acc: the plain version, the mirror and
    (test_torch_cuda.py) the CUDA wrapper refuse two."""
    x = torch.zeros(2, 64, dtype=torch.int32)
    st = torch.zeros(2, 2, dtype=torch.int32)
    for fn in (cf.commit_pages_plain, cf.commit_runs_plain):
        with pytest.raises(ValueError, match="one of"):
            fn(x, x, st, old_terms=True)
        with pytest.raises(ValueError, match="one of"):
            fn(x, x, old_terms=True, acc=x)
        with pytest.raises(ValueError, match="without stored"):
            fn(x, x, st, acc=x)
