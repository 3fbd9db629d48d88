"""The split zone's moves across meshes, on spawned CPU processes
(tests/_torch_procs_regroup_worker.py).

A `PoolGroup` across process counts: four tenants (two shapes, two block
sizes, weights 1-3, two QoS classes) walked (8, 1) over 4 processes ->
(4, 2) over 2 -> (8, 1) over 4, and grown (4, 2) over 2 -> (8, 1) over 4,
at r = 1 and 3, sync and window 2, a wave before each rescale and after
the walk, then a scrub tick.  After every phase each member's block of
every tenant's fields is byte-equal to the one-process group's walk on
the same meshes (which tests/test_torch_elastic.py holds to the
reference's), the tenants, cohorts, weights, QoS classes, configs and
settings are one process's on every member, and each process moved the
bytes the interval intersections reckon.  The states differ by rank.

A snapshot taken on (20, 1) over four processes restored, after a rescale
to (10, 2) over two, by a two-rank loss past r = 1 (ranks on both
processes), then a rescale back and a single loss on process 2; and
rescale_under_traffic with its first rescale only, so it ends on two
processes: each golden-exact on every process and equal to the
one-process run of the same schedule.

A same-group rescale ((8, 1) -> (4, 2) -> (8, 1) over two processes)
sends no byte and gathers nothing (a split `unshard` and `gather_global`
raise there), byte-equal to one process.  Each of the worker's
`MUTATIONS` fails a test."""
import functools

import numpy as np
import pytest
import torch

from repro_torch.dist import procs
from tests import _torch_procs_chaos_worker as cw
from tests import _torch_procs_regroup_worker as rw
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SPECS = {"a": {"scale": (), "w_fsdp": ("data", "model"),
               "w_tp": (None, "model")},
         "b": {"w": ("data",)}}
ROWS, COLS, WORDS = 64, 40, 128        # a's w_fsdp rows and cols, b's words
WHOLE_BYTES = 4 + 4 * 64 * 2           # a's scale and w_tp, replicated on data
SHRINK = [((8, 1), 4), ((4, 2), 2), ((8, 1), 4)]
GROW = [((4, 2), 2), ((8, 1), 4)]
CHAOS = {"seed": 4, "meshes": ((20, 1), (10, 2)), "n_bytes": 5 << 12}
HANG_S = 5.0                           # a mutation's stuck exchange raises


@functools.lru_cache(maxsize=None)
def group_inputs() -> dict:
    rng = np.random.default_rng(29)

    def tenant(key):
        if key == "b":
            return {"w": torch.from_numpy(
                rng.standard_normal(WORDS).astype(np.float32))}
        return {"scale": torch.tensor(np.float32(rng.standard_normal())),
                "w_fsdp": torch.from_numpy(rng.standard_normal(
                    (ROWS, COLS)).astype(np.float32)),
                "w_tp": torch.from_numpy(rng.standard_normal(
                    (4, 64)).astype(np.float32)).to(torch.bfloat16)}
    return {"specs": SPECS,
            "states": [{tid: tenant(key) for tid, (key, *_r) in
                        rw.TENANTS.items()} for _ in range(4)],
            "walks": {None: SHRINK, "grow": GROW}}


@functools.lru_cache(maxsize=None)
def one_process(plan: str) -> dict:
    return rw.run(plan, None, CHAOS if plan == "chaos" else group_inputs())


@pytest.fixture(scope="module")
def regrouped(tmp_path_factory):
    parts = rw.split("group", group_inputs(), 4,
                     tmp_path_factory.mktemp("group"))
    return one_process("group"), parts


@pytest.fixture(scope="module")
def chaos_runs(tmp_path_factory):
    parts = rw.split("chaos", CHAOS, 4, tmp_path_factory.mktemp("chaos"))
    return one_process("chaos"), parts


def reckoned(old_w: int, new_w: int, world: int = 4) -> list:
    """The bytes each process sends when the tenants move from the first
    `old_w` of `world` processes to the first `new_w`: for each tenant the
    rows of its data-sharded leaf it holds and will not hold, and from
    process 0 a copy of the replicated leaves for each newcomer."""
    out = []
    for p in range(world):
        sent = 0
        for key, *_r in rw.TENANTS.values():
            n, unit = (WORDS, 4) if key == "b" else (ROWS, COLS * 4)
            mine = (set(range(p * n // old_w, (p + 1) * n // old_w))
                    if p < old_w else set())
            keep = (set(range(p * n // new_w, (p + 1) * n // new_w))
                    if p < new_w else set())
            sent += len(mine - keep) * unit
            if key == "a" and p == 0:
                sent += WHOLE_BYTES * max(0, new_w - old_w)
        out.append(sent)
    return out


def check_group(want: dict, parts: list, phase: str) -> None:
    """Every member's group: one process's tenants, cohorts, weights, QoS
    classes, configs and settings, and its block of every tenant's
    fields; every data rank held by one member."""
    one = want["group"]
    members = 0
    for rank, part in enumerate(parts):
        got = part[phase]
        if got["pos"] is None:
            assert got["group"] is None, (phase, rank)
            continue
        members += 1
        mine = got["group"]
        for k in ("tenants", "cohorts", "weights", "qos", "configs",
                  "settings"):
            assert mine[k] == one[k], (phase, rank, k)
        for tid, rec in one["tenant"].items():
            assert cw.check_block(rec, mine["tenant"][tid],
                                  f"{phase} {tid} p{rank}")
    assert members == len(parts[0][phase]["procs"]), phase


@pytest.mark.parametrize("case", rw.GROUP_CASES)
def test_group_rescale_is_byte_equal(case, regrouped):
    """Every phase of the walk: each member's group and blocks one
    process's; a spare holds no group; the scrub tick finds nothing."""
    one, parts = regrouped
    for phase in [p for p in one if p.startswith(case)]:
        check_group(one[phase], parts, phase)
    scrub = f"{case}/scrub"
    assert one[scrub]["found"]
    for part in parts:
        found = part[scrub]["found"]
        assert found is None or found == one[scrub]["found"], found
        assert all(not locs for _t, _k, locs in one[scrub]["found"])


@pytest.mark.parametrize("case", rw.GROUP_CASES)
def test_group_rescale_moves_the_reckoned_bytes(case, regrouped):
    """Each rescale of the walk: the bytes each process moved equal the
    interval reckoning summed over the tenants (nothing on one
    process)."""
    one, parts = regrouped
    walk = GROW if case.startswith("grow") else SHRINK
    for i in range(1, len(walk)):
        phase = f"{case}/rescale_{i}"
        assert [p[phase]["moved"] for p in parts] == reckoned(
            walk[i - 1][1], walk[i][1]), phase
        assert one[phase]["moved"] == 0


def _same_run(want: dict, parts: list, name: str) -> None:
    """A run golden-exact and trace-valid on every process, one process's
    recoveries (a spare's skip the steps it sat out, but for the rescales
    and a restore it took part in) and its final blocks."""
    assert want["golden_exact"] and not want["violations"], name
    for rank, part in enumerate(parts):
        got = part[name]
        assert got["golden_exact"] and not got["violations"], (name, rank)
        sat = set(got["spare_steps"])
        assert got["recoveries"] == [
            r for r in want["recoveries"] if r["step"] not in sat
            or r["kind"] in ("rescale", "restore_replay")], (name, rank)
    held = [cw.check_block(want["final"], part[name]["final"],
                           f"{name} p{r}") for r, part in enumerate(parts)]
    assert sum(held) == len(parts[0][name]["final"]["procs"]), name


def test_restore_across_a_rescale(chaos_runs):
    """The snapshot of four processes restored onto two: golden-exact,
    equal to one process; processes 2 and 3 sit out steps 4-11 but send
    their snapshot rows (each a quarter of the state) into the restore."""
    one, parts = chaos_runs
    name = "restore_across_rescale"
    _same_run(one[name], parts, name)
    kinds = [r["kind"] for r in one[name]["recoveries"]]
    assert kinds == ["rescale", "restore_replay", "rescale", "rank_loss"]
    got = [p[name] for p in parts]
    assert [g["spare_steps"] for g in got] == [[], [], list(range(4, 12)),
                                              list(range(4, 12))]
    quarter = CHAOS["n_bytes"] // 4
    restored = [dict(g["moved"]).get("restore_replay") for g in got]
    assert restored == [0, quarter, quarter, quarter], restored


def test_a_run_that_ends_elsewhere(chaos_runs):
    """rescale_under_traffic's 4 -> 2 alone: it ends on processes 0 and 1,
    golden-exact on all four (the golden run's final blocks moved from
    four processes to two), equal to one process."""
    one, parts = chaos_runs
    name = "ends_elsewhere"
    _same_run(one[name], parts, name)
    assert [p[name]["final"]["pos"] for p in parts] == [0, 1, None, None]


def test_same_group_rescale_moves_no_row(tmp_path):
    """Over one group of two processes no byte moves and nothing is
    gathered (the plan raises if a split `unshard` or `gather_global`
    runs), and every field stays one process's."""
    parts = rw.split("same_group", group_inputs(), 2, tmp_path)
    one = one_process("same_group")
    cw.check_blocks(one, parts)
    for phase in one:
        if "rescale" in phase:
            assert [p[phase]["moved"] for p in parts] == [0, 0], phase


def _mutated(mutation, tmp_path) -> None:
    """Run the plan a mutation spoils and the check it must fail."""
    if mutation in ("admit_order", "table_unsent"):
        parts = rw.split("group", group_inputs(), 4, tmp_path,
                         group_timeout=HANG_S, timeout=120.0,
                         cases=("r3_w2",), mutation=mutation)
        one = one_process("group")
        for phase in parts[0]:
            check_group(one[phase], parts, phase)
        return
    name = ("ends_elsewhere" if mutation == "golden_unmoved"
            else "restore_across_rescale")
    parts = rw.split("chaos", CHAOS, 4, tmp_path, group_timeout=HANG_S,
                     timeout=120.0, names=(name,), mutation=mutation)
    _same_run(one_process("chaos")[name], parts, name)


@pytest.mark.parametrize("mutation", rw.MUTATIONS)
def test_a_planted_mutation_fails(mutation, tmp_path):
    """Each mutation of the worker module makes its comparison fail (or an
    exchange it leaves waiting raise)."""
    with pytest.raises((AssertionError, procs.ZoneError)):
        _mutated(mutation, tmp_path)
