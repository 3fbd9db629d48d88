"""A rescale that changes the process count, and the chaos campaign, on a
zone split over spawned CPU processes (tests/_torch_procs_chaos_worker.py).

The W-change rescale: a pool (mlpc; r = 1 and 3; the sync engine and the
bulk engine at window 4, a commit held in its window at each rescale)
walked (8, 1) over 4 processes -> (4, 2) over 2 -> (8, 1) over 4, and
grown (4, 2) over 2 -> (8, 1) over 4.  After every phase each member's
block of every field (the open window's too) is byte-equal to the
one-process port's walk on the same meshes (which tests/test_torch_elastic.py
holds to the reference's), each process moved the bytes that the
interval intersections reckon, and a spare refuses its rank.  The states
differ by rank (random rows of the data-sharded leaf).

The campaign: every quick scenario and the first two storm cells split
over two processes, and `rescale_under_traffic` over four with its
second mesh over two (4 -> 2 -> 4 processes under traffic), each
golden-exact on every process and equal to the one-process campaign on
the same meshes: every member's final block, the recoveries' kind, step
and verdict (a spare's skip the steps it sat out), the moved bytes.
A budget seen otherwise on one process and a final block flipped on one
process are absorbed by agreed verdicts; each of the worker's
`MUTATIONS` fails a test."""
import functools

import numpy as np
import pytest
import torch

from repro_torch.chaos import scenarios
from repro_torch.dist import procs
from tests import _torch_procs_chaos_worker as cw
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SPECS = {"scale": (), "w_fsdp": ("data", "model"), "w_tp": (None, "model")}
ROWS, ROW_BYTES = 64, 174 * 4          # w_fsdp: f32 rows over the data axis
WHOLE_BYTES = 4 + 4 * 64 * 2           # scale and w_tp, replicated on data
SHRINK = [((8, 1), 4), ((4, 2), 2), ((8, 1), 4)]
GROW = [((4, 2), 2), ((8, 1), 4)]
QUICK = (*scenarios.SCENARIOS, *scenarios.GROUP_SCENARIOS,
         *(f"storm_r{r}_w{w}" for r, w in scenarios.STORM_CELLS[:2]))
# the campaign's inputs: at two processes on the reference's meshes, at
# four on meshes whose second G only two divide (as the card's (100, 1) ->
# (50, 2)), over words that both G divide
CAMPAIGN = {2: {"seed": 4, "meshes": ((4, 2), (8, 1)), "n_bytes": 1 << 14,
                "tenant_bytes": 1 << 13},
            4: {"seed": 4, "meshes": ((20, 1), (10, 2)), "n_bytes": 5 << 12,
                "tenant_bytes": 1 << 13}}
HANG_S = 5.0                           # a mutation's stuck exchange raises


@functools.lru_cache(maxsize=None)
def rescale_inputs() -> dict:
    rng = np.random.default_rng(11)

    def state():
        return {"scale": torch.tensor(np.float32(rng.standard_normal())),
                "w_fsdp": torch.from_numpy(rng.standard_normal(
                    (ROWS, 174)).astype(np.float32)),
                "w_tp": torch.from_numpy(rng.standard_normal(
                    (4, 64)).astype(np.float32)).to(torch.bfloat16)}
    return {"specs": SPECS, "bw": 64, "states": [state() for _ in range(4)],
            "walks": {None: SHRINK, "grow": GROW}}


@functools.lru_cache(maxsize=None)
def one_process(plan: str, key) -> dict:
    inp = rescale_inputs() if plan == "rescale" else CAMPAIGN[key[0]]
    return cw.run(plan, None, inp, **dict(key[1:]))


@pytest.fixture(scope="module")
def rescaled(tmp_path_factory):
    parts = cw.split("rescale", rescale_inputs(), 4,
                     tmp_path_factory.mktemp("rescale"))
    return one_process("rescale", (None,)), parts


@pytest.fixture(scope="module")
def campaign2(tmp_path_factory):
    parts = cw.split("campaign", CAMPAIGN[2], 2,
                     tmp_path_factory.mktemp("campaign2"))
    return one_process("campaign", (2,)), parts


def reckoned(old_w: int, new_w: int, world: int = 4) -> list:
    """The bytes each process sends in a move from the first `old_w` of
    `world` processes to the first `new_w`: the rows of the data-sharded
    leaf it holds and will not hold, and from process 0 a copy of the
    replicated leaves for each newcomer (a process the old mesh left
    out)."""
    out = []
    for p in range(world):
        mine = (set(range(p * ROWS // old_w, (p + 1) * ROWS // old_w))
                if p < old_w else set())
        keep = (set(range(p * ROWS // new_w, (p + 1) * ROWS // new_w))
                if p < new_w else set())
        out.append(len(mine - keep) * ROW_BYTES
                   + (WHOLE_BYTES * max(0, new_w - old_w) if p == 0
                      else 0))
    return out


@pytest.mark.parametrize("case", cw.CASES)
def test_w_change_rescale_is_byte_equal(case, rescaled):
    """Every phase of the walk: each member's block of every field equal
    to the one-process walk's, and every data rank held by one member."""
    one, parts = rescaled
    cw.check_blocks(one, parts, [p for p in one if p.startswith(case)])


@pytest.mark.parametrize("case", cw.CASES)
def test_w_change_moves_the_reckoned_bytes(case, rescaled):
    """Each rescale of the walk: the bytes each process moved equal the
    interval reckoning (4 -> 2 and 2 -> 4 move rows; nothing moves on one
    process)."""
    one, parts = rescaled
    walk = GROW if case.startswith("grow") else SHRINK
    for i in range(1, len(walk)):
        phase = f"{case}/rescale_{i}"
        assert [p[phase]["moved"] for p in parts] == reckoned(
            walk[i - 1][1], walk[i][1]), phase
        assert one[phase]["moved"] == 0


def test_a_spare_refuses_its_rank(rescaled):
    """On (4, 2) over processes 0 and 1, processes 2 and 3 hold no pool,
    and reading their rank raises a message that names the mesh."""
    _, parts = rescaled
    got = [p["r1_sync/rescale_1"] for p in parts]
    assert [g["pos"] for g in got] == [0, 1, None, None]
    assert [g["refused"] is None for g in got] == [True, True, False, False]
    for rank in (2, 3):
        assert (f"process {rank} is a spare of a mesh over processes "
                "(0, 1): it holds no block") in got[rank]["refused"]


def _same_campaign(one: dict, parts: list, names=QUICK) -> None:
    """Each scenario golden-exact and trace-valid on every process, its
    members' final blocks and recoveries equal to one process's."""
    for name in names:
        want = one[name]
        assert want["golden_exact"] and not want["violations"], name
        for rank, part in enumerate(parts):
            got = part[name]
            assert got["golden_exact"] and not got["violations"], (
                name, rank)
            sat_out = set(got["spare_steps"])
            assert got["recoveries"] == [
                r for r in want["recoveries"]
                if r["step"] not in sat_out or r["kind"] == "rescale"], (
                name, rank)
        for pool, w in want["final"].items():
            held = [cw.check_block(w, part[name]["final"][pool],
                                   f"{name} {pool} p{r}")
                    for r, part in enumerate(parts)]
            assert sum(held) == len(parts[0][name]["final"][pool]["procs"])


@pytest.mark.parametrize("name", QUICK)
def test_quick_scenario_split_over_two(name, campaign2):
    one, parts = campaign2
    _same_campaign(one, parts, [name])


def test_rescale_under_traffic_four_two_four(tmp_path):
    """(20, 1) over four processes -> (10, 2) over two at n/4, the rank loss
    on the two, -> (20, 1) over four at n/2: golden-exact everywhere, equal
    to one process; processes 2 and 3 sit out steps 6-11; each rescale
    moves a quarter of the state from three processes."""
    names = ("rescale_under_traffic",)
    parts = cw.split("campaign", CAMPAIGN[4], 4, tmp_path, names=names)
    one = one_process("campaign", (4, ("names", names)))
    _same_campaign(one, parts, names)
    got = [p[names[0]] for p in parts]
    assert [g["spare_steps"] for g in got] == [[], [], list(range(6, 12)),
                                              list(range(6, 12))]
    quarter = CAMPAIGN[4]["n_bytes"] // 4
    assert [g["moved"] for g in got] == [[0, quarter], [quarter, 2 * quarter],
                                         [quarter, 0], [quarter, 0]]


def test_budget_fallback_is_agreed(tmp_path):
    """Process 1 alone sees the over-budget loss as solvable; the agreed
    verdict makes every process fall back to its snapshot together, and
    the run is the one-process run."""
    names = ("budget_exhaust_rearm",)
    parts = cw.split("campaign", CAMPAIGN[2], 2, tmp_path, names=names,
                     plant="diverged_budget")
    _same_campaign(one_process("campaign", (2,)), parts, names)


def _flipped_everywhere(parts: list) -> None:
    for rank, part in enumerate(parts):
        assert part["storm_r1_w1"]["golden_exact"] is False, rank


def test_golden_verdict_is_agreed(tmp_path):
    """A final block flipped on process 1 alone: the golden verdict is
    False on every process."""
    _flipped_everywhere(cw.split("campaign", CAMPAIGN[2], 2, tmp_path,
                                 names=("storm_r1_w1",), plant="late_flip"))


def _mutated(mutation, tmp_path) -> None:
    """Run the plan a mutation spoils and the check it must fail."""
    if mutation in ("newcomer_offset", "leaver_unsent"):
        cases = ("grow_r3_w4",) if mutation == "newcomer_offset" else (
            "r1_sync",)
        parts = cw.split("rescale", rescale_inputs(), 4, tmp_path,
                         group_timeout=HANG_S, timeout=120.0, cases=cases,
                         mutation=mutation)
        cw.check_blocks(one_process("rescale", (None,)), parts,
                        [p for p in parts[0] if p.startswith(cases[0])])
        return
    names = {"block_from_zero": ("storm_r1_w1",),
             "unagreed_budget": ("budget_exhaust_rearm",),
             "unagreed_golden": ("storm_r1_w1",)}[mutation]
    parts = cw.split("campaign", CAMPAIGN[2], 2, tmp_path, names=names,
                     group_timeout=HANG_S, timeout=120.0, mutation=mutation)
    if mutation == "unagreed_golden":
        _flipped_everywhere(parts)
    else:
        _same_campaign(one_process("campaign", (2,)), parts, names)


@pytest.mark.parametrize("mutation", cw.MUTATIONS)
def test_a_planted_mutation_fails(mutation, tmp_path):
    """Each mutation of the worker module makes its comparison fail (or an
    exchange it leaves waiting raise)."""
    with pytest.raises((AssertionError, procs.ZoneError)):
        _mutated(mutation, tmp_path)
