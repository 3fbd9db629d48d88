"""The dry run (repro_torch.launch.dryrun) on meta tensors.

  * `dryrun_cell` runs for a reduced config of each family (dense, moe,
    hybrid, ssm, vlm, audio) x each workload (cut to a small batch and
    sequence): its parameter counts are the reference's, its skips the
    reference's, its outputs stay on meta and its record has the
    reference's keys where they mean something here.
  * The protected steps' kernel records on meta equal the records of the
    same steps on the CPU under the cost mode, and the launches those
    steps make with the plain versions standing in for the kernels (the
    CPU rehearsal of chip_smoke: `ops._on_card` true, each `*_cuda`
    wrapper its plain version plus `_build.count_launch`), entry point by
    entry point, at r = 1 and r = 3.
  * No meta entry point calls a plain version: every plain version
    raises while the cells run.
  * `python -m repro_torch.launch.dryrun` writes a record a workload.
"""
import dataclasses
import json

import pytest
import torch

from repro.configs import WORKLOADS as REF_WORKLOADS
from repro.configs import workload_skips as ref_skips
from repro.configs.registry import get_config as ref_config
from repro.models import api as ref_api
from repro_torch import utils
from repro_torch.configs import WORKLOADS, ProtectConfig, TrainConfig, \
    get_config
from repro_torch.kernels import _build, ops
from repro_torch.kernels import commit_fused as cf
from repro_torch.kernels import fletcher as fl
from repro_torch.kernels import gf_parity as gfk
from repro_torch.kernels import xor_parity as xp
from repro_torch.launch import cost, dryrun
from repro_torch.models import api
from repro_torch.models.transformer import build_model
from repro_torch.optim import build_optimizer
from repro_torch.pool import Pool
from tests import _torch_ref as tr
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

FAMILIES = ["qwen3-0.6b", "moonshot-v1-16b-a3b", "recurrentgemma-2b",
            "xlstm-1.3b", "chameleon-34b", "seamless-m4t-large-v2"]
SMALL = {"train_4k": (32, 16), "prefill_32k": (32, 4),
         "decode_32k": (32, 4), "long_500k": (48, 1)}
PLAIN = [(fl, "fletcher_pages_plain"), (fl, "fletcher_stream_plain"),
         (cf, "commit_pages_plain"), (gfk, "gf_scale_plain"),
         (gfk, "sdelta_stack_plain"), (gfk, "syndrome_pages_plain"),
         (xp, "xor_words_plain")]


@pytest.fixture
def small_workloads(monkeypatch):
    for name, (seq, batch) in SMALL.items():
        monkeypatch.setitem(WORKLOADS, name, dataclasses.replace(
            WORKLOADS[name], seq_len=seq, global_batch=batch))


@pytest.fixture
def reduced(monkeypatch):
    """The cells at each family's reduced config on the (4, 2) mesh."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch, True))
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod: tr.zone_mesh("mesh42"))


@pytest.fixture
def no_plain(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a plain kernel version ran")
    for mod, name in PLAIN:
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("arch", FAMILIES)
def test_cells_of_every_family(arch, small_workloads, reduced, no_plain):
    rcfg = ref_config(arch, True)
    for name in WORKLOADS:
        rec = dryrun.dryrun_cell(arch, name, False, verbose=False)
        skip = ref_skips(rcfg, REF_WORKLOADS[name])
        assert rec["status"] == ("skip" if skip else "ok"), rec
        assert (rec["arch"], rec["workload"]) == (arch, name)
        if skip:
            assert rec["skip_reason"] == skip
            continue
        assert rec["n_params"] == ref_api.count_params(rcfg)
        assert rec["n_active_params"] == ref_api.count_params(
            rcfg, active_only=True)
        assert rec["n_devices"] == 8
        for k in ("flops", "hbm_bytes", "launches", "kernels"):
            assert k in rec["cost"]
        assert rec["cost"]["flops"] > 0 and rec["cost"]["launches"] > 0
        assert set(rec["collectives"]["wire_bytes"]) == set(
            cost.COLLECTIVES)
        r = rec["roofline"]
        assert r["bound"] in ("compute", "memory", "collective")
        assert r["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"
        mem = rec["memory"]
        assert mem["peak_bytes"] == mem["argument_bytes"] + mem[
            "step_peak_bytes"]
        assert 0 < mem["argument_bytes_per_rank"] <= mem["argument_bytes"]
        if WORKLOADS[name].kind == "train":
            # the protected step: its commit's kernels and collectives
            assert rec["cost"]["kernels"]["fletcher_blocks"]["launches"] == 1
            assert rec["collectives"]["wire_bytes"]["all-to-all"] > 0
            assert "protection_overhead" in rec
        else:
            assert rec["cost"]["kernels"] == {}


def lockstep_steps(r):
    """The protected train and serve steps of the reduced dense config
    on (4, 2): (name, a function making the step and its meta inputs, a
    function making the step and its CPU inputs)."""
    mesh = tr.zone_mesh("mesh42")
    cfg = get_config("qwen3-0.6b", True)
    model = build_model(cfg, mesh)
    tc = TrainConfig(microbatches=2)
    opt = build_optimizer(tc, cfg)
    pcfg = ProtectConfig(redundancy=r, block_words=64)
    st_abs = api.abstract_train_state(model, opt)
    st_specs = api.train_state_specs(model, opt, mesh)
    meta, cpu = (Pool(mesh, st_abs, st_specs, pcfg, device=d)
                 for d in ("meta", "cpu"))
    gen = torch.Generator().manual_seed(0)
    state = api.init_train_state(model, opt, gen, "cpu")
    tokens = torch.randint(0, cfg.vocab, (4, 32), generator=gen,
                           dtype=torch.int32)
    yield ("train",
           lambda: (dryrun.protected_train_step(model, opt, tc, meta),
                    meta.protector.abstract_protected(st_abs),
                    {"tokens": torch.empty(4, 32, dtype=torch.int32,
                                           device="meta")}),
           lambda: (dryrun.protected_train_step(model, opt, tc, cpu),
                    cpu.protector.init(cpu.to_zone(state)),
                    {"tokens": tokens}))
    max_len, pos = 16, 5
    cache_abs = model.init_cache(4, max_len, device="meta")
    c_specs = model.cache_specs(4, max_len, mesh)
    meta, cpu = (Pool(mesh, cache_abs, c_specs, pcfg, device=d)
                 for d in ("meta", "cpu"))
    params = model.compute_params(state["params"])
    tok = tokens[:, 0]
    yield ("serve",
           lambda: (dryrun.protected_serve_step(model, meta, max_len, pos),
                    utils.tree_map(lambda p: torch.empty(
                        p.shape, dtype=p.dtype, device="meta"), params),
                    torch.empty_like(tok, device="meta"),
                    meta.protector.abstract_protected(cache_abs)),
           lambda: (dryrun.protected_serve_step(model, cpu, max_len, pos),
                    params, tok, cpu.protector.init(cpu.to_zone(
                        model.init_cache(4, max_len, device="cpu")))))


def rehearse(monkeypatch):
    """chip_smoke's CPU rehearsal: every kernel call counts a launch and
    runs its plain version."""
    monkeypatch.setattr(ops, "_on_card", lambda x: True)

    def counted(plain):
        def fn(*a, name, **kw):
            _build.count_launch(name)
            return plain(*a, **kw)
        return fn

    def fletcher(blocks, *, digest):
        if digest:
            return fl.fletcher_stream_plain(blocks)
        return fl.fletcher_pages_plain(blocks), None
    monkeypatch.setattr(fl, "fletcher_pages_cuda", counted(fletcher))
    monkeypatch.setattr(cf, "commit_pages_cuda",
                        counted(cf.commit_pages_plain))
    monkeypatch.setattr(gfk, "syndrome_pages_cuda", counted(
        lambda o, n, c, s=None, *, digest: gfk.syndrome_pages_plain(
            o, n, c, s, digest)))
    monkeypatch.setattr(gfk, "sdelta_stack_cuda",
                        counted(gfk.sdelta_stack_plain))
    monkeypatch.setattr(gfk, "gf_scale_cuda", counted(gfk.gf_scale_plain))
    monkeypatch.setattr(xp, "xor_words_cuda", counted(xp.xor_words_plain))


@pytest.mark.parametrize("r", [1, 3])
def test_kernel_records_equal_the_launches_on_the_cpu(r, monkeypatch):
    for name, on_meta, on_cpu in lockstep_steps(r):
        step, *args = on_meta()
        with cost.CostMode() as m:
            out = step(*args)
        assert all(t.is_meta for t in utils.tree_leaves(out)
                   if isinstance(t, torch.Tensor))
        step, *args = on_cpu()
        with cost.CostMode() as c:
            step(*args)
        assert m.kernels and m.kernels == c.kernels, name
        assert m.wire_bytes == c.wire_bytes, name
        with monkeypatch.context() as mp:
            rehearse(mp)
            step, *args = on_cpu()
            _build.reset_launches()
            step(*args)
            launches = dict(_build.LAUNCHES)
        assert launches == {k: v["launches"] for k, v in m.kernels.items()}
        if r == 3:
            assert "sdelta_stack" in launches or "fused_commit_s" in launches


def test_the_dry_run_cli_writes_a_record_a_workload(tmp_path, small_workloads,
                                                    reduced):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "qwen3-0.6b", "--mesh", "single",
                        "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [r["workload"] for r in recs] == list(WORKLOADS)
    assert [r["status"] for r in recs] == ["ok", "ok", "ok", "skip"]
    assert {r["mesh"] for r in recs} == {"16x16"}
    # --resume keeps the finished cells and runs none again
    assert dryrun.main(["--arch", "qwen3-0.6b", "--mesh", "single",
                        "--out", str(out), "--resume"]) == 0
    assert json.loads(out.read_text()) == recs
