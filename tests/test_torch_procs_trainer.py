"""`runtime.Trainer` on a zone split over two processes: a reduced
qwen3-0.6b (2 layers, d_model 64) trained at seq 16 x batch 8 on the
(4, 2) mesh at microbatches 2 and 4 (tests/_torch_procs_hosts_worker.py
`trainer_plan`): initialization, two steps, a rank loss on process 1's
rank recovered, a scribble scrubbed, a step with a failed canary (not
committed anywhere, the cursor rolled back), a step, a checkpoint and two
steps more; then a fresh trainer restores the other kind of run's
checkpoint — the one-process trainer's in the workers, the workers' in
one process — and replays the surviving redo log to the logged digests.
After every phase each worker's block of the train state, row,
syndromes, checksums and digest, the redo log and the losses are
byte-equal to the one-process trainer's at the same microbatches, and
the two checkpoints hold the same bytes.  With the straggler policy on
and a slow replica that process 0 alone sees, every process drops it as
one process does, with the large exchanges in small pieces.  A gradient
fold in another microbatch order, a process computing another block's
rows, and drops decided on each process's own step times, fail."""
import dataclasses
import functools
import json

import numpy as np
import pytest

import torch

from repro_torch import ZoneMesh
from repro_torch.configs.registry import get_config
from repro_torch.dist import procs
from tests import _torch_procs_hosts_worker as hw
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

MESH = ((4, 2), ("data", "model"))
G = MESH[0][0]


def inputs(microbatches, straggler=0.0) -> dict:
    cfg = get_config("qwen3-0.6b", reduced=True)
    return {"cfg": dataclasses.asdict(cfg), "mesh": MESH, "bw": 64,
            "scrub": 4, "batch": 8, "seq": 16, "seed": 3,
            "microbatches": microbatches, "lost": G - 1,
            "scribble": (G // 2, 70), "straggler": straggler}


@functools.lru_cache(maxsize=None)
def one_plain(microbatches, straggler=0.0) -> dict:
    """The one-process run without a restore (its phases are the first
    ones of every run)."""
    return hw.run("trainer", ZoneMesh(*MESH), inputs(microbatches, straggler))


def _arrays(path):
    with np.load(path / "arrays.npz") as npz:
        return {k: npz[k].tobytes() for k in npz.files}


@pytest.mark.parametrize("microbatches", [2, 4])
def test_split_trainer_is_byte_equal(microbatches, tmp_path):
    """Two workers against one process, phase by phase, with checkpoints
    moving both ways between them."""
    inp = inputs(microbatches)
    whole, split_dir = tmp_path / "whole", tmp_path / "split"
    first = hw.run("trainer", ZoneMesh(*MESH), inp, ckpt_out=str(whole))
    parts = hw.split("trainer", inp, 2, tmp_path, ckpt_out=str(split_dir),
                     ckpt_in=str(whole))
    one = hw.run("trainer", ZoneMesh(*MESH), inp,
                 ckpt_out=str(tmp_path / "again"), ckpt_in=str(split_dir))
    # a checkpoint written changes nothing: the first run's phases are
    # the second's (one "worker" holding every rank)
    hw.check_parts(first, [{**{p: one[p] for p in first},
                            "exchange": {"sent_bytes": 1}}], {None: G})
    outs = [o for p in ("steps_1_2", "canary_fails", "step_3", "steps_4_5")
            for o in one[p]["extra"]["outs"]]
    assert [o["committed"] for o in outs] == [True] * 2 + [False] + \
        [True] * 3
    assert one["restored_replayed"]["extra"]["info"] == {
        "restored_step": 3, "replayed": [4, 5]}
    assert one["restored_replayed"]["extra"]["outs"] == \
        one["steps_4_5"]["extra"]["outs"]
    hw.check_parts(one, parts, {None: G})
    # a checkpoint written split holds the bytes of one written whole
    (a,), (b,) = ([d for d in path.iterdir() if d.name.startswith("step_")]
                  for path in (split_dir, whole))
    assert a.name == b.name == "step_3"
    assert _arrays(a) == _arrays(b)
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    assert ma["digests"] == mb["digests"] and ma["extra"] == mb["extra"]


@pytest.mark.parametrize("mutation", ["fold_order", "other_rows",
                                      "unagreed_straggler"])
def test_split_trainer_mutations_fail(mutation, tmp_path):
    """At four microbatches (two a process) a fold in reverse microbatch
    order, or each process computing the other's microbatches, changes
    the gradients' bits: caught at the first steps.  Straggler drops
    decided on each process's own step times (process 1 sees no slow
    replica) leave replica G - 1's rows unmasked in the second step."""
    straggler = 2.0 if mutation == "unagreed_straggler" else 0.0
    parts = hw.split("trainer", inputs(4, straggler), 2, tmp_path,
                     mutation=mutation)
    with pytest.raises(AssertionError, match="steps_1_2"):
        hw.check_parts(one_plain(4, straggler), parts, {None: G})


def test_split_trainer_straggler_is_byte_equal(tmp_path):
    """Process 0 alone sees replica G - 1 run 8x slow: every process drops
    it from the first step on (process 0's step times, agreed) and masks
    its rows, byte-equal to one process, which drops it too.  The workers
    exchange in pieces of 4 KiB (`procs.in_pieces`' chunked branch): the
    same bits."""
    one = one_plain(4, 2.0)
    outs = [o for p in ("steps_1_2", "canary_fails", "step_3", "steps_4_5")
            for o in one[p]["extra"]["outs"]]
    assert [o.get("dropped_replicas") for o in outs] == [[G - 1]] * 6
    parts = hw.split("trainer", dict(inputs(4, 2.0), chunk_bytes=4096), 2,
                     tmp_path)
    hw.check_parts(one, parts, {None: G})


def test_in_pieces_splits_large_exchanges(monkeypatch):
    """`procs.in_pieces` cuts x's last dim into pieces of at most
    `CHUNK_BYTES` and puts the exchanged pieces back in order: the
    exchange's own result on the whole, for an all-to-all's (W, n) blocks
    and an all-gather's 1-D tensor."""
    monkeypatch.setattr(procs, "CHUNK_BYTES", 16)
    x = torch.arange(20, dtype=torch.float32).reshape(2, 10)
    widths = []

    def swap(v):                      # an all-to-all's shape, W = 2
        widths.append(v.shape[-1])
        return v.flip(0) * 2

    def stack(v):                     # an all-gather's shape, W = 2
        widths.append(v.shape[-1])
        return torch.stack([v, v + 1])
    assert torch.equal(procs.in_pieces(swap, x), x.flip(0) * 2)
    assert widths == [4, 4, 2]
    widths.clear()
    assert torch.equal(procs.in_pieces(stack, x[0]),
                       torch.stack([x[0], x[0] + 1]))
    assert widths == [4, 4, 2]
    widths.clear()
    monkeypatch.setattr(procs, "CHUNK_BYTES", 40)
    assert torch.equal(procs.in_pieces(swap, x), x.flip(0) * 2)
    assert widths == [10]
