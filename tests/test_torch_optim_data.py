"""The port's training inputs and optimizer (repro_torch.data, the PRNG
key words in utils, repro_torch.optim, redolog replay) against the
reference's, on the same numpy inputs.

Batches, key words, specs and redo-log lookups are exact.  The optimizer
runs the reference's f32 update math op for op, so its results are held
to F32_RTOL of the largest magnitude (the two packages' f32 kernels may
round a transcendental one unit apart); with bf16 moments the moments
are held to BF16_RTOL (one bf16 unit).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core import redolog as ref_redolog
from repro.data import synthetic as ref_data
from repro.optim import optimizers as ref_opt
from repro_torch import convert, utils
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import redolog
from repro_torch.data import synthetic
from repro_torch.dist.sharding import P
from repro_torch.optim import optimizers as opt
from tests._torch_ref import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

F32_RTOL = 1e-6
BF16_RTOL = 2 ** -8

CFG = dict(name="t_opt", family="dense", n_layers=2, d_model=32, n_heads=4,
           n_kv=2, d_ff=64, vocab=128)


def close(got, want, rtol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, rtol * scale)


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 7])
@pytest.mark.parametrize("cursor", [0, 1, 5, 1000, 2 ** 32 - 1])
def test_batch_at_is_the_references_bytes(seed, cursor):
    ref = ref_data.SyntheticStream(vocab=151936, seq_len=64, global_batch=8,
                                   seed=seed)
    port = synthetic.SyntheticStream(vocab=151936, seq_len=64,
                                     global_batch=8, seed=seed)
    want, got = ref.batch_at(cursor), port.batch_at(cursor)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype
        assert want[k].tobytes() == got[k].tobytes()


def test_batch_for_stub_embeds_and_device_batch():
    kw = dict(CFG, mm_positions=4, d_model=16)
    ref = ref_data.batch_for(RefModelConfig(**kw), 32, 4, seed=2)
    port = synthetic.batch_for(ModelConfig(**kw), 32, 4, seed=2)
    want = ref.batch_at(9)
    dev = port.device_batch(9, "cpu")
    assert want.keys() == dev.keys() == {"tokens", "mm_embeds"}
    for k in want:
        assert dev[k].numpy().tobytes() == want[k].tobytes()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.device_batch(0)


# -- PRNG key words -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2 ** 31 + 3])
@pytest.mark.parametrize("cursor", [0, 1, 5, 77, 2 ** 31, 2 ** 32 - 1])
def test_fold_in_words_are_the_references(seed, cursor):
    want = np.asarray(jax.random.key_data(
        jax.random.fold_in(jax.random.PRNGKey(seed), cursor)))
    assert utils.fold_in(utils.prng_key(seed), cursor) == [
        int(w) for w in want]
    assert utils.prng_key(seed) == [
        int(w) for w in np.asarray(jax.random.key_data(
            jax.random.PRNGKey(seed)))]


def test_threefry_known_answer():
    """The issue's hand check under jax 0.9.0."""
    assert utils.fold_in(utils.prng_key(0), 5) == [1524306142, 1887795613]
    assert utils.prng_key(7) == [0, 7]


# -- schedule, clip, optimizers ------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(2, 100), (10, 20), (0, 5)])
def test_cosine_schedule(warmup, total):
    ref = ref_opt.cosine_schedule(1e-3, warmup, total)
    port = opt.cosine_schedule(1e-3, warmup, total)
    steps = np.arange(0, total + 5, dtype=np.float32)
    close(port(torch.from_numpy(steps)), ref(jnp.asarray(steps)), F32_RTOL)


def grads_np(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((8, 16)).astype(dtype)},
            "b": rng.standard_normal((32,)).astype(dtype) * 3,
            "c": rng.standard_normal((2, 4, 6)).astype(dtype)}


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e6])
def test_clip_by_global_norm(max_norm):
    g = grads_np(1)
    want, wnorm = ref_opt.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), max_norm)
    got, gnorm = opt.clip_by_global_norm(
        utils.tree_map(torch.from_numpy, g), max_norm)
    close(gnorm, wnorm, F32_RTOL)
    for a, b in zip(utils.tree_leaves(got), jax.tree.leaves(want)):
        close(a, b, F32_RTOL)


def run_both(name, steps=4, moment_dtype=None, wd=0.1):
    """`steps` updates of the reference's and the port's optimizer from
    the same params and gradients; returns both final (params, state)."""
    tc = RefTrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                        optimizer=name, weight_decay=wd)
    ptc = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                      optimizer=name, weight_decay=wd)
    ro = ref_opt.build_optimizer(tc, RefModelConfig(
        **CFG, moment_dtype=moment_dtype))
    po = opt.build_optimizer(ptc, ModelConfig(**CFG,
                                              moment_dtype=moment_dtype))
    p0 = grads_np(0)
    rp, pp = jax.tree.map(jnp.asarray, p0), utils.tree_map(
        torch.from_numpy, p0)
    rs, ps = ro.init(rp), po.init(pp)
    for i in range(steps):
        g = grads_np(10 + i)
        rp, rs = ro.update(jax.tree.map(jnp.asarray, g), rs, rp,
                           jnp.int32(i))
        pp, ps = po.update(utils.tree_map(torch.from_numpy, g), ps, pp,
                           torch.tensor(i, dtype=torch.int32))
    return (rp, rs), (pp, ps)


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_adamw_matches_the_reference(moment_dtype):
    (rp, rs), (pp, ps) = run_both("adamw", moment_dtype=moment_dtype)
    for a, b in zip(utils.tree_leaves(pp), jax.tree.leaves(rp)):
        close(a, b, F32_RTOL)
    rtol = F32_RTOL if moment_dtype is None else BF16_RTOL
    for k in ("m", "v"):
        for a, b in zip(utils.tree_leaves(ps[k]), jax.tree.leaves(rs[k])):
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            close(a, b, rtol)


def test_adafactor_state_and_update_match_the_reference():
    (rp, rs), (pp, ps) = run_both("adafactor", wd=0.01)
    for a, b in zip(utils.tree_leaves(pp), jax.tree.leaves(rp)):
        close(a, b, F32_RTOL)
    # the factored state: {"vr", "vc"} for matrices, {"v"} for vectors
    flat_ref = {jax.tree_util.keystr(p): v
                for p, v in jax.tree.leaves_with_path(rs)}
    assert ps["b"].keys() == {"v"} and ps["a"]["w"].keys() == {"vr", "vc"}
    assert ps["c"]["vr"].shape == (2, 4) and ps["c"]["vc"].shape == (2, 6)
    port_leaves = utils.tree_leaves(ps)
    assert len(port_leaves) == len(flat_ref)
    for a, b in zip(port_leaves, jax.tree.leaves(rs)):
        close(a, b, F32_RTOL)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_state_specs_map_the_param_specs(name):
    ro = ref_opt.build_optimizer(RefTrainConfig(optimizer=name),
                                 RefModelConfig(**CFG))
    po = opt.build_optimizer(TrainConfig(optimizer=name), ModelConfig(**CFG))
    specs = {"a": ("data", "model"), "b": ("model",), "c": (None, "data",
                                                             None)}
    want = ro.state_specs({k: PartitionSpec(*v) for k, v in specs.items()})
    got = po.state_specs({k: P(*v) for k, v in specs.items()})
    flat = [tuple(s) for s in jax.tree.leaves(
        want, is_leaf=lambda x: isinstance(x, PartitionSpec))]
    assert [tuple(s) for s in utils.tree_leaves(got)] == flat


def test_train_config_copies_every_field():
    names = [f.name for f in dataclasses.fields(RefTrainConfig)]
    assert [f.name for f in dataclasses.fields(TrainConfig)] == names
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(
        RefTrainConfig())


# -- redo-log replay -------------------------------------------------------------

def log_pair(capacity=8, steps=11):
    """A reference and a port redo log with `steps` records appended (the
    last one left unmarked), the same words in both."""
    rlog, plog = ref_redolog.make(capacity), redolog.make(capacity, "cpu")
    for s in range(1, steps + 1):
        key = jax.random.fold_in(jax.random.PRNGKey(3), s)
        dig = np.array([s * 7, 2 ** 32 - s], np.uint32)
        rlog = ref_redolog.append(rlog, s, s + 100, key, jnp.asarray(dig))
        plog = redolog.append(plog, torch.tensor(s, dtype=torch.int32),
                              s + 100, utils.fold_in(utils.prng_key(3), s),
                              torch.from_numpy(dig.view(np.int32)))
        if s < steps:
            rlog = ref_redolog.commit_mark(rlog, s)
            plog = redolog.commit_mark(plog, torch.tensor(s,
                                                          dtype=torch.int32))
    return rlog, plog


@pytest.mark.parametrize("from_step", [0, 2, 4, 9, 10, 11])
def test_replayable_steps_and_lookup(from_step):
    rlog, plog = log_pair()
    want = ref_redolog.replayable_steps(rlog, from_step)
    assert redolog.replayable_steps(plog, from_step) == want
    for s in want or [from_step]:
        r, p = ref_redolog.lookup(rlog, s), redolog.lookup(plog, s)
        for k in r:
            assert p[k].numpy().view(np.uint32).tobytes() == np.asarray(
                r[k]).tobytes(), k


def test_replayable_steps_read_steps_unsigned():
    """A step past 2^31 is stored as a negative int32 word; it still
    follows its predecessor."""
    plog = redolog.make(4, "cpu")
    for s in (2 ** 31 - 1, 2 ** 31):
        st = torch.tensor(utils.word(s), dtype=torch.int32)
        plog = redolog.commit_mark(redolog.append(
            plog, st, 0, [0, 0], torch.zeros(2, dtype=torch.int32)), st)
    assert redolog.replayable_steps(plog, 2 ** 31 - 2) == [2 ** 31 - 1,
                                                            2 ** 31]


def test_train_state_to_port_is_bit_exact():
    from repro.models import api as ref_api
    from repro.models.transformer import build_model as ref_build
    cfg = RefModelConfig(**CFG)
    model = ref_build(cfg)
    for name in ("adamw", "adafactor"):
        ro = ref_opt.build_optimizer(RefTrainConfig(optimizer=name), cfg)
        st = ref_api.init_train_state(model, ro, jax.random.PRNGKey(1))
        st = jax.tree.map(np.asarray, st)
        got = convert.train_state_to_port(st, "cpu")
        assert got["step"].dtype == torch.int32 and got["step"].dim() == 0
        want = jax.tree.leaves(st)
        leaves = utils.tree_leaves(got)
        assert len(leaves) == len(want)
        for a, b in zip(leaves, want):
            assert a.numpy().tobytes() == b.tobytes()
