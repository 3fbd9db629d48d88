"""Dispatch for the protection kernels (the reference's kernels/ops.py).

A CUDA tensor launches the hand-written Hopper kernel, and anything the
kernel cannot take raises — there is no fallback.  A CPU tensor takes the
kernel's plain PyTorch version (the tests run here).  A meta tensor (the
dry run) takes the kernel's checks and its outputs' shapes, never the
plain version.  Any other device raises.  Every call reports its bytes
and integer ops to the active cost counter, if there is one
(kernels/cost.py), on each route alike.

Pages come as `(*lead, n, bw)` int32 words; each leading index is one
rank of the zone-stacked state, and one launch covers all of them (every
kernel is per-page independent; only the digest is per rank).  The
syndrome sweeps take each rank's coefficients as a `(*lead, r)` table
(`gf.rank_syndrome_coeffs`), or None at r = 1, which routes to the
single-parity kernels as the reference does (ops.py:113-150) and adds the
plane dim.  The r = 1 verify sweeps form the verdict `bad` in the
kernel, and the r = 1 old-terms sweeps read no stored table; the r >= 2
routes still form `bad` from the old terms ^ stored (`_bad`) and give
the old-terms sweep a zero stored table.  The launch counters (named
after the reference's entry points) and the kernel behind each:

    fletcher_blocks                fletcher_pages<DIGEST=false>
    fletcher_stream                fletcher_pages<DIGEST=true>
    fused_commit                   commit_pages<kCommit,   DIGEST=false>
    fused_verify_commit            commit_pages<kVerify,   DIGEST=false>
    fused_commit_old_terms         commit_pages<kOldTerms, DIGEST=false>
    fused_verify_commit_stream     commit_pages<kVerify,   DIGEST=true>
    fused_commit_stream            commit_pages<kCommit,   DIGEST=true>
    fused_commit_old_terms_stream  commit_pages<kOldTerms, DIGEST=true>
    fused_accum_commit             commit_pages<kAccum,    DIGEST=false>
    fused_accum_commit_stream      commit_pages<kAccum,    DIGEST=true>
    xor_delta, xor_accum           xor_words
    gf_scale                       weight_words<1, RAW0=false>
    sdelta_stack                   weight_words<r, RAW0=true>
                                   (behind syndrome_scale)
    fused_commit_s                 syndrome_pages<r, VERIFY=false, DIGEST=false>
    fused_verify_commit_s          syndrome_pages<r, VERIFY=true,  DIGEST=false>
    fused_commit_old_terms_s       syndrome_pages<r, VERIFY=true,  DIGEST=false>,
                                   stored = 0
    fused_commit_s_stream          syndrome_pages<r, VERIFY=false, DIGEST=true>
    fused_verify_commit_s_stream   syndrome_pages<r, VERIFY=true,  DIGEST=true>
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import utils
from repro_torch.kernels import commit_fused as _cf
from repro_torch.kernels import cost as _cost
from repro_torch.kernels import fletcher as _fl
from repro_torch.kernels import gf_parity as _gf
from repro_torch.kernels import xor_parity as _xor

ENTRY_POINTS = ("fletcher_blocks", "fletcher_stream", "fused_commit",
                "fused_verify_commit", "fused_commit_old_terms",
                "fused_verify_commit_stream", "fused_commit_stream",
                "fused_commit_old_terms_stream", "gf_scale", "sdelta_stack",
                "fused_commit_s", "fused_verify_commit_s",
                "fused_commit_old_terms_s", "fused_commit_s_stream",
                "fused_verify_commit_s_stream", "fused_accum_commit",
                "fused_accum_commit_stream", "xor_delta", "xor_accum")


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no protection kernel for device {x.device}")


def _run(name: str, x: torch.Tensor, card, plain, meta, r: int = 1,
         pages: bool = True):
    """One entry point's call on x's device: `meta()` on meta, else
    `card()` or `plain()`; reported to the active cost counter."""
    with _cost.launch(name, x, r, pages):
        if x.is_meta:
            return meta()
        return card() if _on_card(x) else plain()


def _bad(mism: torch.Tensor) -> torch.Tensor:
    """A page is bad where its old terms ^ stored are not all zero."""
    return (mism != 0).any(dim=-1)


def fletcher_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """`(*lead, n, bw)` -> `(*lead, n, 2)` per-page terms."""
    kw = dict(digest=False, name="fletcher_blocks")
    return _run("fletcher_blocks", blocks,
                lambda: _fl.fletcher_pages_cuda(blocks, **kw)[0],
                lambda: _fl.fletcher_pages_plain(blocks),
                lambda: _fl.fletcher_pages_meta(blocks, **kw)[0])


def fletcher_stream(blocks: torch.Tensor, *, chunk_blocks: int = 8) -> tuple:
    """(terms, per-rank `(*lead, 2)` row digest).  `chunk_blocks` sized the
    reference's VMEM chunks and changes nothing here."""
    kw = dict(digest=True, name="fletcher_stream")
    return _run("fletcher_stream", blocks,
                lambda: _fl.fletcher_pages_cuda(blocks, **kw),
                lambda: _fl.fletcher_stream_plain(blocks),
                lambda: _fl.fletcher_pages_meta(blocks, **kw))


def _sweep(name, old, new, stored=None, *, old_terms=False, digest=False,
           acc=None) -> tuple:
    """One commit_pages sweep: (delta, new terms, bad | old terms | None,
    digest | None), in the mode `stored`, `old_terms` or `acc` names."""
    kw = dict(old_terms=old_terms, digest=digest, acc=acc)
    return _run(name, new,
                lambda: _cf.commit_pages_cuda(old, new, stored, name=name,
                                              **kw),
                lambda: _cf.commit_pages_plain(old, new, stored, **kw),
                lambda: _cf.commit_pages_meta(old, new, stored, name=name,
                                              **kw))


def fused_commit(old: torch.Tensor, new: torch.Tensor) -> tuple:
    """(delta, new terms)."""
    return _sweep("fused_commit", old, new)[:2]


def fused_verify_commit(old: torch.Tensor, new: torch.Tensor,
                        stored: torch.Tensor) -> tuple:
    """(delta, new terms, bad) — bad `(*lead, n)` marks old pages whose
    terms no longer match `stored` (verify-at-micro-buffer-open), formed
    in the sweep."""
    return _sweep("fused_verify_commit", old, new, stored)[:3]


def fused_commit_old_terms(old: torch.Tensor, new: torch.Tensor) -> tuple:
    """(delta, new terms, old terms): the reference's verify sweep with
    stored = 0, which here reads no stored table."""
    return _sweep("fused_commit_old_terms", old, new, old_terms=True)[:3]


def fused_verify_commit_stream(old: torch.Tensor, new: torch.Tensor,
                               stored: torch.Tensor, *,
                               chunk_blocks: int = 8) -> tuple:
    """(delta, new terms, bad, per-rank row digest of the new pages)."""
    return _sweep("fused_verify_commit_stream", old, new, stored,
                  digest=True)


def fused_commit_stream(old: torch.Tensor, new: torch.Tensor) -> tuple:
    """(delta, new terms, per-rank row digest of the new pages)."""
    delta, ck, _, dig = _sweep("fused_commit_stream", old, new, digest=True)
    return delta, ck, dig


def fused_commit_old_terms_stream(old: torch.Tensor,
                                  new: torch.Tensor) -> tuple:
    """(delta, new terms, old terms, digest): the streamed old-terms
    sweep."""
    return _sweep("fused_commit_old_terms_stream", old, new, old_terms=True,
                  digest=True)


# -- the deferred-epoch engine (window > 1) ----------------------------------

def fused_accum_commit(acc: torch.Tensor, old: torch.Tensor,
                       new: torch.Tensor) -> tuple:
    """(acc ^ old ^ new, old terms, new terms) — the reference's order: the
    step's delta folded into the epoch accumulator (a fresh tensor; `acc`
    is not written) and both pages' terms for the row digest."""
    acc_out, terms, old_terms, _ = _sweep("fused_accum_commit", old, new,
                                          acc=acc)
    return acc_out, old_terms, terms


def fused_accum_commit_stream(acc: torch.Tensor, old: torch.Tensor,
                              new: torch.Tensor) -> tuple:
    """(acc ^ old ^ new, old terms, new terms, per-rank row digest of the
    new pages)."""
    acc_out, terms, old_terms, dig = _sweep("fused_accum_commit_stream", old,
                                            new, digest=True, acc=acc)
    return acc_out, old_terms, terms, dig


def _xor2(a: torch.Tensor, b: torch.Tensor, name: str) -> torch.Tensor:
    return _run(name, a, lambda: _xor.xor_words_cuda(a, b, name=name),
                lambda: _xor.xor_words_plain(a, b),
                lambda: _xor.xor_words_meta(a, b, name=name), pages=False)


def xor_delta(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """The parity patch old ^ new, a fresh tensor of their shape."""
    return _xor2(old, new, "xor_delta")


def xor_accum(parity: torch.Tensor, patch: torch.Tensor) -> torch.Tensor:
    """A patch applied to parity: parity ^ patch, a fresh tensor."""
    return _xor2(parity, patch, "xor_accum")


# -- the GF(2^32) syndrome stack (r >= 2) ------------------------------------

def gf_scale(x: torch.Tensor, coeff: int) -> torch.Tensor:
    """Element-wise y = coeff · x in GF(2^32), coeff a host u32."""
    return _run("gf_scale", x,
                lambda: _gf.gf_scale_cuda(x, coeff, name="gf_scale"),
                lambda: _gf.gf_scale_plain(x, coeff),
                lambda: _gf.gf_scale_meta(x, coeff, name="gf_scale"),
                pages=False)


def syndrome_scale(x: torch.Tensor,
                   coeffs: Optional[torch.Tensor]) -> torch.Tensor:
    """`(*lead, m)` words -> the `(*lead, r, m)` weighted stack from one
    read of x (the `sdelta_stack` kernel): plane 0 raw, plane k =
    coeffs[..., k] · x.  coeffs None means r = 1: the words themselves, as
    a view."""
    if coeffs is None:
        return x.unsqueeze(-2)
    return _run("sdelta_stack", x,
                lambda: _gf.sdelta_stack_cuda(x, coeffs, name="sdelta_stack"),
                lambda: _gf.sdelta_stack_plain(x, coeffs),
                lambda: _gf.sdelta_stack_meta(x, coeffs, name="sdelta_stack"),
                r=coeffs.shape[-1], pages=False)


def _s_sweep(old, new, coeffs, stored, digest, name):
    kw = dict(digest=digest, name=name)
    return _run(name, new,
                lambda: _gf.syndrome_pages_cuda(old, new, coeffs, stored,
                                                **kw),
                lambda: _gf.syndrome_pages_plain(old, new, coeffs, stored,
                                                 digest),
                lambda: _gf.syndrome_pages_meta(old, new, coeffs, stored,
                                                **kw),
                r=coeffs.shape[-1])


def fused_commit_s(old: torch.Tensor, new: torch.Tensor,
                   coeffs: Optional[torch.Tensor] = None) -> tuple:
    """(sdelta `(*lead, r, n, bw)`, new terms)."""
    if coeffs is None:
        delta, ck = fused_commit(old, new)
        return delta.unsqueeze(-3), ck
    sdelta, ck, _, _ = _s_sweep(old, new, coeffs, None, False,
                                "fused_commit_s")
    return sdelta, ck


def fused_verify_commit_s(old: torch.Tensor, new: torch.Tensor,
                          stored: torch.Tensor,
                          coeffs: Optional[torch.Tensor] = None) -> tuple:
    """(sdelta, new terms, bad `(*lead, n)`)."""
    if coeffs is None:
        delta, ck, bad = fused_verify_commit(old, new, stored)
        return delta.unsqueeze(-3), ck, bad
    sdelta, ck, mism, _ = _s_sweep(old, new, coeffs, stored, False,
                                   "fused_verify_commit_s")
    return sdelta, ck, _bad(mism)


def fused_commit_old_terms_s(old: torch.Tensor, new: torch.Tensor,
                             coeffs: Optional[torch.Tensor] = None) -> tuple:
    """(sdelta, new terms, old terms)."""
    if coeffs is None:
        delta, ck, old_ck = fused_commit_old_terms(old, new)
        return delta.unsqueeze(-3), ck, old_ck
    zeros = torch.zeros(*new.shape[:-1], 2, dtype=torch.int32,
                        device=new.device)
    return _s_sweep(old, new, coeffs, zeros, False,
                    "fused_commit_old_terms_s")[:3]


def fused_commit_s_stream(old: torch.Tensor, new: torch.Tensor,
                          coeffs: Optional[torch.Tensor] = None) -> tuple:
    """(sdelta, new terms, per-rank row digest)."""
    if coeffs is None:
        delta, ck, dig = fused_commit_stream(old, new)
        return delta.unsqueeze(-3), ck, dig
    sdelta, ck, _, dig = _s_sweep(old, new, coeffs, None, True,
                                  "fused_commit_s_stream")
    return sdelta, ck, dig


def fused_verify_commit_s_stream(old: torch.Tensor, new: torch.Tensor,
                                 stored: torch.Tensor,
                                 coeffs: Optional[torch.Tensor] = None
                                 ) -> tuple:
    """(sdelta, new terms, bad, per-rank row digest)."""
    if coeffs is None:
        delta, ck, bad, dig = fused_verify_commit_stream(old, new, stored)
        return delta.unsqueeze(-3), ck, bad, dig
    sdelta, ck, mism, dig = _s_sweep(old, new, coeffs, stored, True,
                                     "fused_verify_commit_s_stream")
    return sdelta, ck, _bad(mism), dig


# -- the async commit ring ----------------------------------------------------

def stage_verdict(checks, device=None) -> torch.Tensor:
    """Fold per-buffer canary verdicts into one 0-d device bool with
    `torch.all` (an empty list is True), so that a staged commit carries
    them without a host read.  `checks` may mix device bools with host
    bools (a quarantined tenant's `False`); the host ones are put on the
    verdicts' device first, or on `device` (default: the card) when no
    verdict is a tensor.  There is nothing to tile: it is not a kernel."""
    dev = next((c.device for c in checks if isinstance(c, torch.Tensor)),
               None)
    if dev is None:
        dev = utils.resolve_device(device)
    flat = [c.reshape(-1).to(torch.bool) if isinstance(c, torch.Tensor)
            else torch.full((1,), bool(c), dtype=torch.bool, device=dev)
            for c in checks]
    if not flat:
        return torch.ones((), dtype=torch.bool, device=dev)
    return torch.cat(flat).all()


# -- tenant-batched entry points (repro_torch.tenancy cohorts) ---------------
# A cohort of T same-shape tenants commits through one launch: the tenant
# dim goes in front of the zone-stacked lead, `(T, *mesh_dims, n, bw)`, and
# every kernel is per page (only the digest is per rank, and these flat
# kernels carry none), so one launch over T x G ranks is byte-equal to T
# launches.  Each rank's coefficients are the same in every tenant: the
# `(*mesh_dims, r)` table is tiled over T.  Launches count under the
# underlying entry point's name.

def _tile(coeffs: Optional[torch.Tensor], t: int) -> Optional[torch.Tensor]:
    return (None if coeffs is None
            else coeffs.expand(t, *coeffs.shape).contiguous())


def _rows(sdelta: torch.Tensor) -> torch.Tensor:
    """`(*lead, r, n, bw)` planes -> `(*lead, r, n * bw)` delta rows."""
    return sdelta.reshape(*sdelta.shape[:-2], -1)


def fletcher_blocks_tb(blocks: torch.Tensor) -> torch.Tensor:
    """`(T, *M, n, bw)` -> `(T, *M, n, 2)` terms, one launch."""
    return fletcher_blocks(blocks)


def fused_commit_s_tb(old: torch.Tensor, new: torch.Tensor,
                      coeffs: Optional[torch.Tensor] = None) -> tuple:
    """(sdelta rows `(T, *M, r, n * bw)`, new terms `(T, *M, n, 2)`);
    `coeffs` the cohort's `(*M, r)` table (None at r = 1)."""
    sdelta, ck = fused_commit_s(old, new, _tile(coeffs, new.shape[0]))
    return _rows(sdelta), ck


def fused_verify_commit_s_tb(old: torch.Tensor, new: torch.Tensor,
                             stored: torch.Tensor,
                             coeffs: Optional[torch.Tensor] = None) -> tuple:
    """(sdelta rows, new terms, bad `(T, *M, n)`)."""
    sdelta, ck, bad = fused_verify_commit_s(
        old, new, stored, _tile(coeffs, new.shape[0]))
    return _rows(sdelta), ck, bad


def fused_accum_commit_tb(acc: torch.Tensor, old: torch.Tensor,
                          new: torch.Tensor) -> tuple:
    """(acc ^ old ^ new, old terms, new terms), each per tenant."""
    return fused_accum_commit(acc, old, new)


def syndrome_scale_tb(delta: torch.Tensor,
                      coeffs: Optional[torch.Tensor]) -> torch.Tensor:
    """`(T, *M, m)` per-tenant words -> `(T, *M, r, m)` weighted stacks."""
    return syndrome_scale(delta, _tile(coeffs, delta.shape[0]))


def stream_chunk_blocks(n_blocks: int, block_words: int, *,
                        threshold_words: int,
                        chunk_words: int) -> Optional[int]:
    """The engines' flat-vs-streamed policy, as in the reference: the
    streamed chunk height, or None when the row stays on the flat kernels.
    On the card both routes run the same kernel (the streamed one adds the
    digest); the launch counters show which route a commit took."""
    if threshold_words <= 0 or n_blocks * block_words < threshold_words:
        return None
    return max(1, min(int(chunk_words) // int(block_words), n_blocks))
