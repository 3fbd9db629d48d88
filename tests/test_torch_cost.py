"""The dry run's cost model (repro_torch.launch.cost) against the
reference's (launch/hlo_cost.py, launch/hlo_analysis.py), as
tests/test_hlo_cost.py holds the reference's against XLA's own numbers.

  * A matrix product counts 2·M·N·K; a loop over stacked weights and the
    same products written out count alike, and as the reference's
    trip-count roll-up counts the scanned program.
  * Bound selection and the useful ratio, on the H100's peaks.
  * On a reduced dense config with no mesh, the matrix-product FLOPs of
    prefill equal the reference's dot FLOPs of the same jitted function;
    those of the train step equal the reference's plus the two products
    the port recomputes where XLA does not: each chunk's unembedding
    (the port's chunked cross entropy recomputes its logits in the
    backward; the reference's scan keeps them) and each layer's Q·K^T
    (the flash backward recomputes the scores; XLA shares them with the
    checkpointed forward's).  The totals' ratios are printed.
  * The zone collectives' wire bytes of one protected bulk commit at
    r = 1 and r = 3 (with and without verify) on (4, 2) equal the
    reference's compiled commit's, kind by kind and count by count.
    The reference's roll-up (`hlo_cost.analyze_text`, which its dry run
    records) is the yardstick: `hlo_analysis.parse_collectives` misses
    the tuple-shaped all-to-all that XLA's CPU backend emits.
  * `model_flops` is the reference's 6·N·D / 2·N·D exactly.
  * On meta, the memo of repeated ops changes no count.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import WORKLOADS as REF_WORKLOADS
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.configs.registry import get_config as ref_config
from repro.core.txn import Protector as RefProtector
from repro.launch import hlo_cost
from repro.models import api as ref_api
from repro.models.transformer import build_model as ref_build
from repro.optim import build_optimizer as ref_optimizer
from repro_torch.configs import WORKLOADS, TrainConfig, get_config
from repro_torch.core.txn import Protector
from repro_torch.dist import sharding
from repro_torch.dist.sharding import P
from repro_torch.launch import cost, dryrun
from repro_torch.models import api
from repro_torch.models import params as prm
from repro_torch.models.transformer import build_model
from repro_torch.optim import build_optimizer
from tests import _torch_ref as tr
from tests._torch_ref import compile_cache, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("compile_cache", "one_thread")


def meta(*shape):
    return torch.empty(shape, device="meta")


def test_matmul_flops_are_2mnk():
    for dev in ("meta", "cpu"):
        a = torch.empty(128, 256, device=dev)
        b = torch.empty(256, 512, device=dev)
        with cost.CostMode() as m:
            a @ b
        assert m.flops == m.mm_flops == 2 * 128 * 256 * 512
        assert m.ops == m.launches == 1
        assert m.hbm_bytes == (128 * 256 + 256 * 512 + 128 * 512) * 4


def test_einsum_and_linear_count_their_products():
    x, w = meta(4, 8, 16), meta(32, 16)
    with cost.CostMode() as m:
        torch.nn.functional.linear(x, w)
        torch.einsum("bsd,ed->bse", x, w)
    assert m.mm_flops == 2 * (2 * 4 * 8 * 16 * 32)


def test_elementwise_ops_count_one_flop_an_element():
    x = meta(64, 32)
    with cost.CostMode() as m:
        y = torch.exp(x) + 1.0
        y.view(-1)                         # a view: no op, no flop
        torch.empty(10, device="meta")     # an allocation: no op
    assert m.flops == 2 * 64 * 32 and m.ops == 2 and m.mm_flops == 0
    with cost.CostMode() as m:
        (x > 0).to(torch.int32)            # no floating result
    assert m.flops == 0 and m.ops == 2


def test_scanned_and_unrolled_agree_with_the_reference():
    """A loop over stacked weights, the same products written out, and the
    reference's trip-count roll-up of the scanned jax program: 7 x 2m^3."""
    n, m_ = 7, 64
    ws, x0 = meta(n, m_, m_), meta(m_, m_)
    with cost.CostMode() as scanned:
        x = x0
        for w in ws:
            x = w @ x
    separate = [meta(m_, m_) for _ in range(n)]
    with cost.CostMode() as unrolled:
        x = x0
        for w in separate:
            x = w @ x
    assert scanned.mm_flops == unrolled.mm_flops == n * 2 * m_ ** 3

    def body(x, w):
        return w @ x, ()
    text = jax.jit(lambda w, x: jax.lax.scan(body, x, w)[0]).lower(
        jax.ShapeDtypeStruct((n, m_, m_), jnp.float32),
        jax.ShapeDtypeStruct((m_, m_), jnp.float32)).compile().as_text()
    assert scanned.flops == pytest.approx(hlo_cost.analyze_text(text).flops,
                                          rel=0.1)


def test_roofline_terms_bound_selection():
    r = cost.roofline_terms(flops=1e15, hbm_bytes=1e9, wire_bytes=1e6)
    assert r.bound == "compute"
    assert r.compute_s == pytest.approx(1e15 / 989.4e12)
    r = cost.roofline_terms(flops=1e9, hbm_bytes=1e13, wire_bytes=1e6)
    assert r.bound == "memory" and r.memory_s == pytest.approx(1e13 / 3.35e12)
    r = cost.roofline_terms(flops=1e9, hbm_bytes=1e9, wire_bytes=1e13)
    assert r.bound == "collective"
    assert r.collective_s == pytest.approx(1e13 / 450e9)
    r = cost.roofline_terms(1e12, 1e9, 1e6, model_flops=5e11)
    assert r.useful_ratio == pytest.approx(0.5)
    assert cost.DEVICE == "NVIDIA H100 80GB HBM3, 700.00 W"


def dot_flops(text: str) -> float:
    """The reference's roll-up with only dots (and convolutions) counted:
    no dtype counts as floating, so no elementwise op adds a flop."""
    saved = hlo_cost._FLOAT_DTYPES
    hlo_cost._FLOAT_DTYPES = frozenset()
    try:
        return hlo_cost.analyze_text(text).flops
    finally:
        hlo_cost._FLOAT_DTYPES = saved


B, S = 2, 128


def dense_pair():
    cfg, rcfg = get_config("qwen3-0.6b", True), ref_config("qwen3-0.6b",
                                                          True)
    return cfg, rcfg, build_model(cfg), ref_build(rcfg)


def test_prefill_products_equal_the_references(capsys):
    cfg, rcfg, model, rmodel = dense_pair()
    text = jax.jit(ref_api.make_prefill(rmodel)).lower(
        rmodel.abstract_params(),
        {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}).compile() \
        .as_text()
    params = prm.abstract_params(model.param_defs())
    batch = {"tokens": torch.empty(B, S, dtype=torch.int32, device="meta")}
    with cost.CostMode() as m:
        api.make_prefill(model)(params, batch)
    want = dot_flops(text)
    assert m.mm_flops == pytest.approx(want, rel=0.02)
    with capsys.disabled():
        print(f"\nprefill: products {m.mm_flops / want:.4f} of the "
              f"reference's, all flops "
              f"{m.flops / hlo_cost.analyze_text(text).flops:.4f}")


def test_train_step_products_equal_the_references_and_the_recomputes(
        capsys):
    cfg, rcfg, model, rmodel = dense_pair()
    ropt = ref_optimizer(RefTrainConfig(), rcfg)
    text = jax.jit(ref_api.make_train_step(rmodel, ropt, RefTrainConfig())) \
        .lower(ref_api.abstract_train_state(rmodel, ropt),
               {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}) \
        .compile().as_text()
    opt = build_optimizer(TrainConfig(), cfg)
    state = api.abstract_train_state(model, opt)
    batch = {"tokens": torch.empty(B, S, dtype=torch.int32, device="meta")}
    with cost.CostMode() as m:
        api.make_train_step(model, opt, TrainConfig())(state, batch)
    # one chunk of S positions, one attention tile of S x S (chunk 256)
    unembed = 2 * B * S * cfg.d_model * cfg.vocab
    scores = cfg.n_layers * 2 * B * cfg.n_heads * S * S * cfg.hd
    want = dot_flops(text)
    assert m.mm_flops == pytest.approx(want + unembed + scores, rel=0.02)
    with capsys.disabled():
        print(f"\ntrain step: products {m.mm_flops / want:.4f} of the "
              f"reference's, {m.mm_flops / (want + unembed + scores):.4f} "
              f"of it with the two recomputes, all flops "
              f"{m.flops / hlo_cost.analyze_text(text).flops:.4f}")


def commit_pair(r):
    mesh, zmesh = tr.jax_mesh("mesh42"), tr.zone_mesh("mesh42")
    rng = np.random.default_rng(0)
    state = {"a": rng.standard_normal((64, 256)).astype(np.float32),
             "b": rng.standard_normal((32, 128)).astype(np.float32)}
    specs = {"a": ("data", "model"), "b": (None, "model")}
    ref = RefProtector(mesh, jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state),
        tr.jax_specs(specs), redundancy=r, block_words=64)
    port = Protector(zmesh, tr.to_torch(state), tr.port_specs(specs),
                     redundancy=r, block_words=64)
    zone = {k: sharding.shard(torch.from_numpy(v), P(*specs[k]), zmesh)
            for k, v in state.items()}
    return ref, port, tr.to_jax(state, tr.jax_specs(specs), mesh), zone


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("r", [1, 3])
def test_commit_wire_bytes_equal_the_references(r, verify):
    ref, port, jstate, zone = commit_pair(r)
    commit = ref.make_commit(verify_old=verify)
    prot = ref.init(jstate)
    new = jax.tree.map(lambda x: x * 2, jstate)
    text = jax.jit(lambda p, n: commit(p, n)).lower(prot, new).compile() \
        .as_text()
    want = hlo_cost.analyze_text(text)
    pprot = port.init(zone)
    with cost.CostMode() as m:
        port.make_commit(verify_old=verify)(
            pprot, {k: v * 2 for k, v in zone.items()})
    n_dev = 8
    assert want.wire_bytes["all-to-all"] > 0
    for kind in cost.COLLECTIVES:
        assert m.wire_bytes[kind] / n_dev == pytest.approx(
            want.wire_bytes[kind], rel=0.01), kind
        assert m.wire_counts[kind] == want.coll_counts[kind], kind
    assert sum(m.wire_bytes.values()) / n_dev == pytest.approx(
        want.total_wire_bytes, rel=0.01)


@pytest.mark.parametrize("name", ["train_4k", "prefill_32k", "decode_32k"])
def test_model_flops_are_the_references(name, monkeypatch):
    """The record's model_flops (per device) x n_devices: 6 x active
    parameters x tokens for train, 2 x for prefill, 2 x active x batch for
    decode, with the reference's parameter counts; the cell cut to a
    small batch and sequence."""
    wl = dataclasses.replace(WORKLOADS[name], seq_len=64, global_batch=8)
    monkeypatch.setitem(WORKLOADS, name, wl)
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch, True))
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod: tr.zone_mesh("mesh42"))
    rcfg = ref_config("moonshot-v1-16b-a3b", True)
    rec = dryrun.dryrun_cell("moonshot-v1-16b-a3b", name, False,
                             verbose=False)
    n_active = ref_api.count_params(rcfg, active_only=True)
    assert n_active < ref_api.count_params(rcfg)
    tokens = wl.global_batch * (1 if wl.kind == "decode" else wl.seq_len)
    want = (6.0 if wl.kind == "train" else 2.0) * n_active * tokens
    assert rec["roofline"]["model_flops"] * rec["n_devices"] == want
    assert REF_WORKLOADS[name].kind == wl.kind


def test_the_memo_changes_no_count():
    """The same reduced train step on meta with and without the memo of
    repeated ops: every count equal."""
    cfg = get_config("qwen3-0.6b", True)
    model = build_model(cfg)
    opt = build_optimizer(TrainConfig(), cfg)
    step = api.make_train_step(model, opt, TrainConfig())
    batch = {"tokens": torch.empty(B, S, dtype=torch.int32, device="meta")}
    recs = []
    for memo in (True, False):
        with cost.CostMode(memo=memo) as m:
            step(api.abstract_train_state(model, opt), batch)
        recs.append(m.record())
    assert recs[0] == recs[1]
    assert recs[0]["peak_bytes"] > 0
