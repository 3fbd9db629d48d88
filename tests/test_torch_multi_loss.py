"""Recovery and verification at redundancy r = 2 and r = 3 against the
reference: the scrub and pre-check verdicts, `recover_e` for every e <= r
(the last rank included), page repair, the seeded multi-rank loss, the
Pool quickstart with `Fault.multi_loss`, the e > r budget refusal, and
the tensor solve against the host oracle — byte-equal throughout."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ProtectConfig as RefConfig
from repro.core import gf as ref_gf
from repro.pool import Fault as RefFault
from repro.pool import Pool as RefPool
from repro.runtime import failure as ref_failure
from repro_torch import Fault, Pool, ProtectConfig
from repro_torch.core import gf
from repro_torch.runtime import failure
from tests._torch_ref import (Pair, as_words, assert_prot_same, jax_mesh,
                              jax_specs, port_specs, state_like, to_jax,
                              to_torch, words, zone_mesh)
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _verdicts(out):
    return {k: np.asarray(v).tolist() for k, v in out.items()}


@pytest.mark.parametrize("mesh_name,r,losses", [
    ("mesh42", 3, [(2,), (0, 3), (1, 2, 3)]),
    ("mesh81", 3, [(7,), (3, 7), (0, 4, 7)]),
    ("mesh81", 2, [(0, 7)])])
def test_scrub_precheck_and_recover_e_match_reference(mesh_name, r, losses):
    pr = Pair(mesh_name, "mlpc", redundancy=r)
    pr.commit(state_like(1, pr.cur), seed=1)
    assert _verdicts(pr.port.scrub(pr.pp)) == _verdicts(pr.ref.scrub(pr.rp))
    assert _verdicts(pr.port.local_scrub(pr.pp)) == _verdicts(
        pr.ref.local_scrub(pr.rp))
    assert pr.port.overhead_report() == pr.ref.overhead_report()
    for lost in losses:
        if len(lost) == 1:
            rp, _ = ref_failure.inject_rank_loss(pr.ref, pr.rp, lost[0])
            pp, _ = failure.inject_rank_loss(pr.port, pr.pp, lost[0])
        else:
            rp, rev = ref_failure.inject_multi_rank_loss(pr.ref, pr.rp, lost)
            pp, pev = failure.inject_multi_rank_loss(pr.port, pr.pp, lost)
            assert pev.lost_ranks == rev.lost_ranks == list(lost)
        assert_prot_same(rp, pr.mesh, pp)
        # a lost stack plane shows in the pre-check and the scrub alike
        assert _verdicts(pr.port.scrub(pp)) == _verdicts(pr.ref.scrub(rp))
        assert _verdicts(pr.port.local_scrub(pp)) == _verdicts(
            pr.ref.local_scrub(rp))
        rp, rok = pr.ref.recover_e(rp, lost)
        pp, pok = pr.port.recover_e(pp, lost)
        assert bool(rok) and bool(pok)
        assert_prot_same(rp, pr.mesh, pp)
        assert_prot_same(pr.rp, pr.mesh, pp)          # the rows came back
    with pytest.raises(RuntimeError, match="syndrome budget exhausted"):
        pr.port.recover_e(pr.pp, range(r + 1))


def test_scribble_scrub_and_repair_at_r3():
    pr = Pair("mesh42", "mlpc", redundancy=3)
    pr.commit(state_like(1, pr.cur), seed=1)
    # words 3 and 100 lie in the payload, in different stack segments
    # (seg = 64 words)
    rp, _ = ref_failure.inject_scribble(pr.ref, pr.rp, 1, [3, 100])
    pp, _ = failure.inject_scribble(pr.port, pr.pp, 1, [3, 100])
    rs, ps = _verdicts(pr.ref.scrub(rp)), _verdicts(pr.port.scrub(pp))
    assert ps == rs and ps["synd_ok"] == [False] * 3
    rl, pl = _verdicts(pr.ref.local_scrub(rp)), _verdicts(
        pr.port.local_scrub(pp))
    assert pl == rl and pl["bad_count"] == 4
    rp, rok = pr.ref.repair_pages(rp, [1, 1], [0, 1])
    pp, pok = pr.port.repair_pages(pp, [1, 1], [0, 1])
    assert bool(rok) and bool(pok)
    assert_prot_same(rp, pr.mesh, pp)
    assert_prot_same(pr.rp, pr.mesh, pp)


def test_seeded_multi_rank_loss_picks_the_reference_victims():
    pr = Pair("mesh81", "mlp", redundancy=3)
    for seed, e in ((0, 2), (5, 3)):
        rp, rev = ref_failure.seeded_multi_rank_loss(pr.ref, pr.rp, seed, e=e)
        pp, pev = failure.seeded_multi_rank_loss(pr.port, pr.pp, seed, e=e)
        assert pev.lost_ranks == rev.lost_ranks and len(pev.lost_ranks) == e
        assert_prot_same(rp, pr.mesh, pp)
    rp, rev = ref_failure.inject_double_rank_loss(pr.ref, pr.rp, (1, 6))
    pp, pev = failure.inject_double_rank_loss(pr.port, pr.pp, (1, 6))
    assert pev.kind == rev.kind == "multi_loss"
    rp, _ = pr.ref.recover_two(rp, 6, 1)
    pp, pok = pr.port.recover_two(pp, 6, 1)
    assert bool(pok)
    assert_prot_same(rp, pr.mesh, pp)


# -- the Pool at r = 3 --------------------------------------------------------

SPECS = {"w_fsdp": ("data", "model"), "w_tp": (None, "model"), "scale": ()}


def _quickstart_state():
    return {
        "w_fsdp": np.asarray(jnp.arange(16 * 64, dtype=jnp.float32)
                             .reshape(16, 64) * .01),
        "w_tp": np.asarray(jnp.ones((8, 32), jnp.bfloat16)),
        "scale": np.asarray(jnp.float32(1.0)),
    }


def _doubled(state):
    return {k: np.asarray((jnp.asarray(v) * 2).astype(v.dtype))
            for k, v in state.items()}


def _report(rep):
    d = dataclasses.asdict(rep)
    for k in ("solve_ms", "reverify_ms", "total_ms", "queue_wait_ms"):
        d.pop(k, None)
    return d


def _metrics(pool):
    return {k: pool.metrics.counter(k).value
            for k in ("pool_budget_exhausted_total",)} | {
        k: pool.metrics.gauge(k).value
        for k in ("pool_budget_remaining", "pool_redundancy")}


def test_pool_quickstart_with_multi_loss_at_r3():
    mesh, zmesh = jax_mesh("mesh42"), zone_mesh("mesh42")
    state = _quickstart_state()
    cfg = dict(mode="mlpc", redundancy=3, block_words=64)
    ref = RefPool.open(to_jax(state, SPECS, mesh), jax_specs(SPECS),
                       mesh=mesh, config=RefConfig(**cfg))
    port = Pool.open(to_torch(state), port_specs(SPECS), mesh=zmesh,
                     config=ProtectConfig(**cfg), device="cpu")

    def check():
        assert_prot_same(ref.prot, mesh, port.prot)
        assert ref.step == port.step

    check()
    assert port.redundancy == ref.redundancy == 3
    assert port.overhead_report() == ref.overhead_report()
    assert _metrics(port) == _metrics(ref)

    # transactional update, then a verified one
    new_state = _doubled(state)
    key = jax.random.PRNGKey(0)
    with ref.transaction(rng_key=key) as rtx:
        rtx.stage(to_jax(new_state, SPECS, mesh))
    with port.transaction(rng_key=[int(w) for w in jax.random.key_data(key)]
                          ) as ptx:
        ptx.stage(to_torch(new_state))
    assert rtx.ok and ptx.ok
    check()
    newer = _doubled(new_state)
    assert bool(ref.commit(to_jax(newer, SPECS, mesh), verify_old=True,
                           dirty_pages=[0, 1]))
    assert bool(port.commit(to_torch(newer), verify_old=True,
                            dirty_pages=[0, 1]))
    check()
    want = np.asarray(port.state["w_fsdp"]).copy()

    # three ranks lost at once: rebuilt online from the r = 3 stack
    ref.prot, rev = ref_failure.inject_multi_rank_loss(ref.protector,
                                                       ref.prot, (0, 2, 3))
    port.prot, pev = failure.inject_multi_rank_loss(port.protector,
                                                    port.prot, (0, 2, 3))
    check()
    rrep = ref.recover(RefFault.from_event(rev))
    prep = port.recover(Fault.from_event(pev))
    assert prep.verified and prep.lost_ranks == [0, 2, 3]
    assert prep.synd_ok == [True] * 3
    assert _report(prep) == _report(rrep)
    check()
    np.testing.assert_array_equal(np.asarray(port.state["w_fsdp"]), want)

    # a scribble, scrub + repair; then the pre-check
    ref.prot, _ = ref_failure.inject_scribble(ref.protector, ref.prot,
                                              rank=1, word_offsets=[7])
    port.prot, _ = failure.inject_scribble(port.protector, port.prot,
                                           rank=1, word_offsets=[7])
    rsr, psr = ref.scrub(), port.scrub()
    assert dataclasses.asdict(psr) == dataclasses.asdict(rsr)
    assert psr.repaired and psr.repair_ok and len(psr.synd_ok) == 3
    check()
    assert dataclasses.asdict(port.precheck()) == dataclasses.asdict(
        ref.precheck())

    # a canary abort leaves everything as it was; stats agree
    zeros = {k: np.zeros_like(v) for k, v in newer.items()}
    with ref.transaction() as rtx:
        rtx.watch(ref_failure.smashed_canary_buffer(4096))
        rtx.stage(to_jax(zeros, SPECS, mesh))
    with port.transaction() as ptx:
        ptx.watch(failure.smashed_canary_buffer(4096, device="cpu"))
        ptx.stage(to_torch(zeros))
    assert ptx.aborted and not ptx.ok and rtx.aborted and not rtx.ok
    check()
    rs, ps = ref.stats(), port.stats()
    for k in ("redundancy", "commits", "aborted_commits", "recoveries",
              "scrub", "budget_exhausted"):
        assert ps[k] == rs[k], k

    # e > r: refused up front, latched critical, re-armed by init
    with pytest.raises(RuntimeError, match="syndrome budget exhausted") as pe:
        port.recover(Fault.multi_loss(0, 1, 2, 3))
    with pytest.raises(RuntimeError, match="syndrome budget exhausted") as re:
        ref.recover(RefFault.multi_loss(0, 1, 2, 3))
    assert str(pe.value) == str(re.value)
    assert _metrics(port) == _metrics(ref)
    assert port.stats()["budget_exhausted"] == ref.stats()["budget_exhausted"]
    assert port.health().status == ref.health().status == "critical"
    assert port.health().reasons == ref.health().reasons
    check()
    ref.init(to_jax(newer, SPECS, mesh))
    port.init(to_torch(newer))
    assert _metrics(port) == _metrics(ref)
    assert port.health().status == ref.health().status
    check()


def test_host_solve_against_the_tensor_solve():
    """`gf.solve_e` (through the gf_scale entry point) against the
    reference's host oracle, word by word."""
    rng = np.random.default_rng(4)
    for ranks in ((3, 7), (0, 5, 99), (1, 2, 3, 98)):
        e = len(ranks)
        d = rng.integers(0, 2**32, size=(e, 16), dtype=np.uint32)
        got = gf.solve_e(as_words(d), ranks)
        for w in range(16):
            want = ref_gf.solve_e_int([int(v) for v in d[:, w]], ranks)
            assert [int(words(g)[w]) for g in got] == want
