"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip where no GPU is present.  This file imports
neither JAX nor the reference (only the port and chip_smoke.py's kernel
calls), so it also runs on a machine that has only PyTorch and the CUDA
toolkit; run it from the repo root:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.kernels import _build, ops
from repro_torch.kernels import commit_fused as port_cf
from repro_torch.kernels import fletcher as port_fl


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels build with nvcc "
                    "and run only on the card")
    return torch.device("cuda")


def _pages(shape, seed, device):
    bits = np.random.default_rng(seed).integers(0, 2**32, size=shape,
                                                dtype=np.uint32)
    return torch.from_numpy(bits.view(np.int32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("lead,n,bw", [((), 1, 64), ((), 13, 64),
                                       ((3,), 13, 1024), ((2, 2), 300, 1024)])
@pytest.mark.parametrize("r", [2, 3, 4])
def test_cuda_kernels_match_plain(card, lead, n, bw, r):
    """Every entry point's kernel (all 19) against its plain version (the
    calls of chip_smoke.entry_calls), the syndrome sweeps at r; one launch
    each."""
    old, new = _pages((*lead, n, bw), 1, card), _pages((*lead, n, bw), 2, card)
    stored = port_fl.fletcher_pages_plain(old)
    stored[..., ::3, 0] ^= 1                   # a few corrupted stored rows
    coeffs = chip_smoke.coeff_table(lead, r, card)
    calls = chip_smoke.entry_calls(old, new, stored, coeffs, new)
    assert set(calls) == set(ops.ENTRY_POINTS)
    _build.reset_launches()
    got = {name: kernel() for name, (kernel, _) in calls.items()}
    torch.cuda.synchronize()
    for name, (_, plain) in calls.items():
        want = plain()
        assert len(got[name]) == len(want), name
        for a, b in zip(got[name], want):
            assert torch.equal(a, b), name
    assert _build.LAUNCHES == {k: 1 for k in ops.ENTRY_POINTS}


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_they_cannot_launch(card):
    x = torch.zeros(4, 66, dtype=torch.int32, device=card)      # bw % 4 != 0
    with pytest.raises(ValueError, match="bw % 4"):
        ops.fletcher_blocks(x)
    with pytest.raises(ValueError, match="int32"):
        ops.fletcher_blocks(torch.zeros(4, 64, device=card))
    y = torch.zeros(4, 128, dtype=torch.int32, device=card)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_commit(y, y)
    z = torch.zeros(4, 64, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="coefficients"):
        ops.fused_commit_s(z, z, torch.ones(4, 5, dtype=torch.int32,
                                            device=card))      # r = 5
    with pytest.raises(ValueError, match="coefficients"):
        ops.syndrome_scale(z, torch.ones(3, 2, dtype=torch.int32,
                                         device=card))
    with pytest.raises(ValueError, match="m % 4"):
        ops.gf_scale(torch.zeros(6, dtype=torch.int32, device=card), 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_accum_commit(y, y, y)
    with pytest.raises(ValueError, match="must match"):
        ops.fused_accum_commit_stream(torch.zeros(3, 64, dtype=torch.int32,
                                                  device=card), z, z)
    with pytest.raises(ValueError, match="one of"):
        port_cf.commit_pages_cuda(z, z, torch.zeros(4, 2, dtype=torch.int32,
                                                    device=card),
                                  old_terms=True, digest=False,
                                  name="fused_commit_old_terms")
    with pytest.raises(ValueError, match="contiguous"):
        ops.xor_delta(y, y)
    with pytest.raises(ValueError, match="one shape"):
        ops.xor_accum(z, x)


@pytest.mark.cuda
@pytest.mark.parametrize("n,off_a,off_b", [(1001, 0, 0), (7, 0, 0),
                                           (4096, 1, 2), (8194, 1, 0),
                                           (0, 0, 0)])
def test_cuda_xor_takes_any_length_and_alignment(card, n, off_a, off_b):
    """The XOR kernel on 1-D runs whose length is not a multiple of 4 (its
    scalar tail) and slices off a 16-byte boundary (its scalar path)."""
    a = _pages((n + 3,), 3, card)[off_a:off_a + n]
    b = _pages((n + 3,), 4, card)[off_b:off_b + n]
    for fn in (ops.xor_delta, ops.xor_accum):
        got = fn(a, b)
        torch.cuda.synchronize()
        assert torch.equal(got, a ^ b)


@pytest.mark.cuda
@pytest.mark.parametrize("r,lead,m", chip_smoke.weight_edge_cases())
def test_cuda_weight_words_edges(card, r, lead, m):
    """weight_words (gf_scale at r = 1, sdelta_stack at r = 2..4) against
    its plain version: leads 1, 3 and 100; rows of one uint4, of 1020
    words, of a block's share ± 4 words and of a main-path rank; a
    coefficient table holding 0 and 1 (gf_scale: by 0, 1 and a rank
    coefficient)."""
    gen = np.random.default_rng(r * 1000 + lead + m)

    def pages(shape):
        bits = gen.integers(0, 2**32, size=shape, dtype=np.uint32)
        return torch.from_numpy(bits.view(np.int32)).to(card)
    _build.reset_launches()
    cases = chip_smoke.weight_case(pages, card, r, lead, m)
    for kernel, plain in cases:
        got = kernel()
        torch.cuda.synchronize()
        assert torch.equal(got, plain())
    name = "gf_scale" if r == 1 else "sdelta_stack"
    assert _build.LAUNCHES == {name: len(cases)}


@pytest.mark.cuda
@pytest.mark.parametrize("r,lead,n,bw", chip_smoke.run_edge_cases())
def test_cuda_page_run_edges(card, r, lead, n, bw):
    """The page-run sweeps against their plain versions: the five
    syndrome_pages entry points at r = 2..4 (a coefficient table holding 0
    and 1) and, at r = 2, both fletcher_pages entry points; leads 1, 3 and
    100 of n pages around the K pages a CTA takes (1, K - 1, K, K + 1), 16
    and 2600; pages of 4 and 1024 words."""
    gen = np.random.default_rng(r * 1_000_003 + lead * 10_007 + n * 11 + bw)

    def pages(shape):
        bits = gen.integers(0, 2**32, size=shape, dtype=np.uint32)
        return torch.from_numpy(bits.view(np.int32)).to(card)
    _build.reset_launches()
    cases = chip_smoke.run_case(pages, card, r, lead, n, bw)
    for name, kernel, plain in cases:
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        assert len(got) == len(want), name
        for a, b in zip(got, want):
            assert torch.equal(a, b), name
    assert _build.LAUNCHES == {name: 1 for name, *_ in cases}


# -- the async commit ring and tenancy waves on the card ------------------------

def _small_pool_state(card, seed=0):
    from repro_torch import P, ZoneMesh
    gen = torch.Generator().manual_seed(seed)
    mesh = ZoneMesh((4, 2), ("data", "model"))
    state = {"w": torch.randn(16, 64, generator=gen).to(card),
             "v": torch.randn(8, 32, generator=gen).to(torch.bfloat16)
             .to(card)}
    return mesh, state, {"w": P("data", "model"), "v": P(None, "model")}


def _bumped(state, k):
    return {"w": state["w"] + k, "v": (state["v"] * 2).to(torch.bfloat16)}


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 4])
def test_cuda_commit_async_dispatch_never_syncs(card, window):
    """Warm every path once, then enqueue bulk, patch (sync engine) and
    staged-canary commits through a ring that is not full under
    `torch.cuda.set_sync_debug_mode("error")`: any host sync raises.  The
    drain reads the verdicts after it."""
    from repro_torch import Pool, ProtectConfig
    mesh, state, specs = _small_pool_state(card)
    pool = Pool.open(state, specs, mesh=mesh, config=ProtectConfig(
        mode="mlpc", redundancy=3, window=window, block_words=64,
        pipeline_depth=8))
    patch = {} if window > 1 else {"dirty_pages": [0, 1]}
    staged = ops.stage_verdict([torch.ones((), dtype=torch.bool,
                                           device=card)])

    def dispatch(k):
        return [pool.commit_async(_bumped(state, k), data_cursor=k),
                pool.commit_async(_bumped(state, k + 1), data_cursor=k + 1,
                                  **patch),
                pool.commit_async(_bumped(state, k + 2), data_cursor=k + 2,
                                  canary_ok=staged)]
    dispatch(1)
    pool.drain()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tickets = dispatch(4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert pool.in_flight == 3 and all(t.event is not None for t in tickets)
    pool.drain()
    assert all(t.result() for t in tickets)


@pytest.mark.cuda
def test_cuda_ticket_ready_queries_its_event(card):
    """A ticket over a verdict still queued behind a spin kernel is not
    ready; after the device catches up it is: the ring asks the event."""
    from repro_torch import Pool, ProtectConfig
    mesh, state, specs = _small_pool_state(card)
    pool = Pool.open(state, specs, mesh=mesh, config=ProtectConfig(
        block_words=64, pipeline_depth=4))
    pool.commit_async(_bumped(state, 1))
    pool.drain()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)                 # ~0.1 s of spinning
    t = pool.commit_async(_bumped(state, 2))
    assert t.event is not None and not t.ready() and pool.poll() == []
    torch.cuda.synchronize()
    assert t.ready() and pool.poll() == [t] and t.result() is True


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 4])
def test_cuda_batched_wave_launches_each_kernel_once(card, window):
    """Three tenants of one cohort: each batched wave launches each of its
    kernels once, not three times, and matches solo pools byte for byte."""
    from repro_torch import Pool, ProtectConfig
    from repro_torch.tenancy import PoolGroup
    mesh, state, specs = _small_pool_state(card)
    cfg = ProtectConfig(mode="mlpc", redundancy=3, window=window,
                        block_words=64)
    group = PoolGroup(mesh)
    solos = []
    for t in range(3):
        st = _bumped(state, 10 * t)
        group.admit(f"t{t}", st, specs, config=cfg)
        solos.append(Pool.open(st, specs, mesh=mesh, config=cfg))
    waves = [({"fletcher_blocks": 1, "sdelta_stack": 1}, {}),
             ({"fused_verify_commit_s": 1}, {"verify_old": True})]
    if window > 1:
        waves = [({"fused_accum_commit": 1}, {})] * 3 + [
            ({"fused_accum_commit": 1, "sdelta_stack": 1}, {})]
    for k, (want, kw) in enumerate(waves, 1):
        ups = {f"t{t}": _bumped(state, 10 * t + k) for t in range(3)}
        _build.reset_launches()
        oks = group.commit(ups, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == want, k
        for t in range(3):
            solos[t].commit(ups[f"t{t}"], **kw)
            assert bool(oks[f"t{t}"])
    for t in range(3):
        a, b = group[f"t{t}"].pool.prot, solos[t].prot
        for f in ("synd", "cksums", "digest", "row", "step"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        for f in ("step", "data_cursor", "rng", "digest", "mark"):
            assert torch.equal(getattr(a.log, f), getattr(b.log, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("lead,n,bw", chip_smoke.commit_edge_cases())
def test_cuda_commit_edges(card, lead, n, bw):
    """commit_pages' nine entry points (the eight of rows 3-8 and
    fused_accum_commit_tb) against their plain versions: leads 1, 3 and
    100 of 1, K - 1, K, K + 1, 16 and 2600 pages (K the pages a CTA
    takes) of 4 and 1024 words."""
    gen = np.random.default_rng(lead * 10_007 + n * 11 + bw)

    def pages(shape):
        bits = gen.integers(0, 2**32, size=shape, dtype=np.uint32)
        return torch.from_numpy(bits.view(np.int32)).to(card)
    _build.reset_launches()
    cases = chip_smoke.commit_case(pages, card, lead, n, bw)
    for name, kernel, plain in cases:
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        assert len(got) == len(want), name
        for a, b in zip(got, want):
            assert torch.equal(a, b), name
    assert _build.LAUNCHES == {**{name: 1 for name in chip_smoke.COMMIT},
                               "fused_accum_commit": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 4])
def test_cuda_rescale_matches_the_cpu(card, window):
    """(4, 2) -> (8, 1) -> (4, 2) at r = 3 with a commit pending in the
    window: every protected field on the card equals the same pool's on
    the CPU, and the rescale launches the init's kernels (plus the
    flush's)."""
    from repro_torch import Pool, ProtectConfig, ZoneMesh
    mesh, state, specs = _small_pool_state(card)
    cfg = ProtectConfig(mode="mlpc", redundancy=3, window=window,
                        block_words=64)
    cpu = {k: v.cpu() for k, v in state.items()}
    gpu_pool = Pool.open(state, specs, mesh=mesh, config=cfg, device=card)
    cpu_pool = Pool.open(cpu, specs, mesh=mesh, config=cfg, device="cpu")
    for k, shape in enumerate(((8, 1), (4, 2)), 1):
        target = ZoneMesh(shape, ("data", "model"))
        gpu_pool.commit(_bumped(state, k))
        cpu_pool.commit(_bumped(cpu, k))
        _build.reset_launches()
        gpu_pool = gpu_pool.rescale(target)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == {"fletcher_blocks": 1,
                                   "sdelta_stack": 2 if window > 1 else 1}
        cpu_pool = cpu_pool.rescale(target)
        a, b = gpu_pool.prot, cpu_pool.prot
        for f in ("synd", "cksums", "digest", "row", "step"):
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
        for leaf in a.state:
            assert torch.equal(a.state[leaf].cpu(), b.state[leaf]), leaf
        assert gpu_pool.protector.group_size == shape[0]


@pytest.mark.cuda
def test_cuda_traffic_step_matches_the_cpu(card):
    """The chaos workload's initial state and ten traffic steps (the exact
    fused multiply-add) on the card equal the CPU's, bit for bit."""
    from repro_torch.chaos import workload
    n = (1 << 22) + 5
    w, c = workload.initial_state(n, 7, card), workload.initial_state(n, 7,
                                                                      "cpu")
    assert torch.equal(w.cpu(), c)
    for t in range(10):
        b = np.float32(t % workload.PERIOD) * workload.STEP_BIAS
        w = workload.fma(w, workload.GAIN, b)
        c = workload.fma(c, workload.GAIN, b)
        assert torch.equal(w.cpu(), c), t


@pytest.mark.cuda
@pytest.mark.parametrize("r,window,depth", [(1, 1, 1), (3, 4, 4)])
def test_cuda_server_matches_the_cpu(card, r, window, depth):
    """The reduced qwen3-0.6b server on the card gives the CPU's tokens,
    and its pool, flushed, is byte-equal to a pool opened fresh over its
    final cache."""
    from repro_torch import Pool, ProtectConfig, ZoneMesh
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime.server import Server
    cfg = get_config("qwen3-0.6b", reduced=True)
    mesh = ZoneMesh((4, 2), ("data", "model"))
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    prompt = torch.randint(0, cfg.vocab, (4, 6),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", card):
        srv = Server(cfg, ProtectConfig(mode="mlpc", block_words=64,
                                        redundancy=r, window=window,
                                        pipeline_depth=depth,
                                        scrub_period=4),
                     mesh, batch=4, max_len=24, device=dev)
        srv.start(params)
        _build.reset_launches()
        out[str(dev)] = srv.generate(prompt, 6)
        srv.flush()
        pool = srv.pool
        fresh = Pool.open(pool.state, pool.state_specs, mesh=mesh,
                          config=pool.config, device=dev)
        for k in ("row", "synd", "cksums", "digest"):
            assert torch.equal(getattr(pool.prot, k),
                               getattr(fresh.prot, k)), k
    assert _build.LAUNCHES, "the card's server launched no kernel"
    np.testing.assert_array_equal(out["cpu"], out[str(card)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_cuda_attend_matches_the_cpu(card, dtype, causal, window):
    """The chunked training attention (its forward and its recomputing
    backward) on the card against the same function on the CPU: f32 within
    1e-5 of the largest |value|, bf16 within 2^-7 (the card's and the
    CPU's matmuls sum in another order)."""
    from repro_torch.models import attention
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(4)
    q, k, v, dout = (torch.randn(s, generator=gen).to(dt) for s in (
        (2, 96, 4, 16), (2, 96, 2, 16), (2, 96, 2, 16), (2, 96, 4, 16)))
    out = {}
    for dev in ("cpu", card):
        xs = [t.to(dev).detach().requires_grad_() for t in (q, k, v)]
        o = attention.attend(*xs, causal=causal, window=window, chunk=32)
        o.backward(dout.to(dev))
        out[str(dev)] = [t.detach().float().cpu() for t in
                         (o, *(x.grad for x in xs))]
    rtol = 1e-5 if dtype == "float32" else 2 ** -7
    for a, b in zip(out["cpu"], out[str(card)]):
        assert (a - b).abs().max() <= rtol * a.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_train_step_gives_the_same_bytes_twice(card, dtype):
    """Two train steps from one state on the card give the same bytes:
    the embedding's backward sums its rows in a fixed order
    (`layers.row_sums`), so the step is deterministic, as the trainer's
    replay and chip_smoke's tr b / c comparison need."""
    import dataclasses
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import batch_for
    from repro_torch.models import api
    from repro_torch.models.transformer import build_model
    from repro_torch.optim import build_optimizer
    from repro_torch import utils
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              compute_dtype=dtype)
    model = build_model(cfg)
    opt = build_optimizer(TrainConfig(), cfg)
    state = api.init_train_state(model, opt, torch.Generator(card)
                                 .manual_seed(0), card)
    step = api.make_train_step(model, opt, TrainConfig())
    batch = batch_for(cfg, 64, 8, 0).device_batch(0, card)
    a, am = step(state, batch)
    b, bm = step(state, batch)
    assert torch.equal(am["loss"], bm["loss"])
    for x, y in zip(utils.tree_leaves(a), utils.tree_leaves(b)):
        assert torch.equal(x, y)
