"""`runtime.Server` on a zone split over processes: a reduced qwen3-0.6b
(2 layers, d_model 64) served at batch 8, max_len 16 on the (4, 2) mesh,
W in {2, 4}, each process decoding its block's rows of the batch
(tests/_torch_procs_hosts_worker.py `server_plan`): at mlpc r = 1
(window 1, depth 1), at r = 3 with window 4 (the deferred patch engine
on every cache leaf) and at depth 2 (the commit ring), each through a
prompt whose rows differ, a rank loss on a rank off process 0 recovered
mid-decode, the tokens and a scrub.  After every phase each worker's
block of the pool's fields (cache, row, syndromes, checksums, digest,
redo log, the open window) is byte-equal to the one-process server's,
its reports equal, and every worker returns the one-process server's
whole (B, n_new) tokens.  A process that decodes another block's rows,
and tokens gathered out of rank order, fail."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import ZoneMesh
from repro_torch.configs.registry import get_config
from repro_torch.models.transformer import build_model
from tests import _torch_procs_hosts_worker as hw
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

MESH = ((4, 2), ("data", "model"))
G = MESH[0][0]


@functools.lru_cache(maxsize=None)
def inputs() -> dict:
    cfg = get_config("qwen3-0.6b", reduced=True)
    params = build_model(cfg, ZoneMesh(*MESH)).init(
        torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, (8, 4)).astype(np.int32)
    assert len({tuple(r) for r in prompt}) == 8      # the rows differ
    return {"cfg": dataclasses.asdict(cfg), "mesh": MESH, "params": params,
            "bw": 64, "scrub": 4, "batch": 8, "max_len": 16,
            "prompt": torch.from_numpy(prompt), "n_new": 6, "event": 5,
            "lost": G - 1}


@functools.lru_cache(maxsize=None)
def one_process() -> dict:
    return hw.run("server", ZoneMesh(*MESH), inputs())


@pytest.mark.parametrize("world", [2, 4])
def test_split_server_is_byte_equal(world, tmp_path):
    """Every case, every phase: each worker's block of the pool and the
    gathered tokens equal to the one-process server's."""
    one = one_process()
    toks = {c: one[f"{c}/generate"]["extra"]["tokens"]
            for c in hw.SERVER_CASES}
    assert all(t.shape == (8, 6) for t in toks.values())
    # the protected engines serve the same tokens
    assert all(np.array_equal(t, toks["sync"]) for t in toks.values())
    assert all(one[f"{c}/rank_loss"]["extra"]["verified"]
               for c in hw.SERVER_CASES)
    hw.check_parts(one, hw.split("server", inputs(), world, tmp_path),
                   {None: G})


@pytest.mark.parametrize("mutation,phase", [
    ("other_rows", "sync/rank_loss"), ("tokens_reversed", "sync/generate")])
def test_split_server_mutations_fail(mutation, phase, tmp_path):
    """A process that decodes the next process's rows writes other
    caches; tokens stacked in reverse process order are not the
    one-process tokens: each fails the comparison at its first phase."""
    parts = hw.split("server", inputs(), 2, tmp_path, cases=("sync",),
                     mutation=mutation)
    one = {k: v for k, v in one_process().items() if k.startswith("sync/")}
    with pytest.raises(AssertionError, match=phase):
        hw.check_parts(one, parts, {None: G})
