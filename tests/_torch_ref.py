"""Shared helpers for the port's tests: the reference (JAX) and the port
(PyTorch) fed the same numpy inputs, and their protected states compared
byte for byte.

The reference's meshes are built with Auto axis types: under jax 0.9
`jax.make_mesh` defaults to Explicit axes, on which the reference's
`Protector.commit` raises a ShardingTypeError at core/txn.py:514.  The
shapes and axis names are those of the conftest fixtures.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, NamedSharding, PartitionSpec

from repro.core import gf as ref_gf
from repro.core.epoch import DeferredProtector as RefDeferred
from repro.core.txn import Mode as RefMode
from repro.core.txn import Protector as RefProtector
from repro.kernels import ref
from repro_torch import convert, utils
from repro_torch.core.epoch import DeferredProtector
from repro_torch.core.txn import Mode, Protector
from repro_torch.dist import sharding
from repro_torch.dist.sharding import P, ZoneMesh

MESHES = {
    "mesh42": ((4, 2), ("data", "model")),
    "mesh81": ((8, 1), ("data", "model")),
    "mesh_pod": ((2, 2, 2), ("pod", "data", "model")),
}


def jax_mesh(name):
    shape, axes = MESHES[name]
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def zone_mesh(name):
    shape, axes = MESHES[name]
    return ZoneMesh(shape, axes)


def small_state_np():
    """conftest.small_state's values as numpy (bf16 via ml_dtypes) + specs."""
    state = {
        "w1": np.asarray(jnp.arange(8 * 64, dtype=jnp.float32)
                         .reshape(8, 64) * 0.1),
        "w2": np.asarray((jnp.arange(16 * 32, dtype=jnp.float32) * 0.01)
                         .astype(jnp.bfloat16).reshape(16, 32)),
        "scale": np.asarray(jnp.float32(3.25)),
    }
    specs = {"w1": ("data", "model"), "w2": (None, "model"), "scale": ()}
    return state, specs


def jax_specs(specs):
    return {k: PartitionSpec(*v) for k, v in specs.items()}


def port_specs(specs):
    return {k: P(*v) for k, v in specs.items()}


def to_jax(state_np, specs, mesh):
    js = jax_specs(specs)
    return {k: jax.device_put(v, NamedSharding(mesh, js[k]))
            for k, v in state_np.items()}


def to_torch(state_np):
    """Global numpy leaves -> CPU tensors (bf16 bit-exact)."""
    return utils.tree_map(lambda a: convert._leaf(a, "cpu"), state_np)


def stacked(arr, mesh) -> np.ndarray:
    """A jax.Array's per-device shards, zone-stacked in mesh order."""
    by_dev = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
    shards = [by_dev[d.id] for d in mesh.devices.flat]
    return np.stack(shards).reshape(mesh.devices.shape + shards[0].shape)


def ref_fields(prot, mesh) -> dict:
    """The reference's ProtectedState as convert's field dict (numpy)."""
    def arr(x):
        return None if x is None else np.asarray(x)
    log = None
    if prot.log is not None:
        log = {k: np.asarray(getattr(prot.log, k))
               for k in ("step", "data_cursor", "rng", "digest", "mark")}
    return {
        "state": jax.tree.map(lambda v: stacked(v, mesh), prot.state),
        "replica": (None if prot.replica is None else
                    jax.tree.map(lambda v: stacked(v, mesh), prot.replica)),
        "synd": arr(prot.synd), "cksums": arr(prot.cksums),
        "digest": arr(prot.digest), "row": arr(prot.row),
        "log": log, "step": np.asarray(prot.step),
    }


def _same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, f"{what}: {a is None} vs {b is None}"
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    assert a.tobytes() == b.tobytes(), f"{what}: bytes differ"


def _same_tree(ref, port, what):
    """Two (nested) dicts of leaves byte-equal, key for key."""
    if not isinstance(ref, dict):
        _same(ref, port, what)
        return
    assert ref.keys() == port.keys(), what
    for k in ref:
        _same_tree(ref[k], port[k], f"{what}.{k}")


def assert_same(ref: dict, port: dict) -> None:
    """Every field of two field dicts byte-equal."""
    for k in ("synd", "cksums", "digest", "row", "step"):
        _same(ref[k], port[k], k)
    for tree in ("state", "replica"):
        if ref[tree] is None or port[tree] is None:
            assert ref[tree] is None and port[tree] is None, tree
            continue
        _same_tree(ref[tree], port[tree], tree)
    if ref["log"] is None or port["log"] is None:
        assert ref["log"] is None and port["log"] is None, "log"
    else:
        for k in ref["log"]:
            _same(ref["log"][k], port["log"][k], f"log.{k}")


def assert_prot_same(ref_prot, mesh, port_prot) -> None:
    assert_same(ref_fields(ref_prot, mesh), convert.from_port(port_prot))


def words(t: torch.Tensor) -> np.ndarray:
    """Port int32 words -> the reference's uint32 view."""
    return t.cpu().numpy().view(np.uint32)


def rand_u32(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, size=shape,
                                                dtype=np.uint32)


def as_words(a: np.ndarray) -> torch.Tensor:
    """u32 numpy -> port int32 words on the CPU."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def state_like(seed, like):
    """A fresh global state of `like`'s shapes from a seeded numpy rng
    (bf16 rounded by JAX so both packages get the same bits)."""
    rng = np.random.default_rng(seed)
    return {
        "w1": rng.standard_normal(like["w1"].shape).astype(np.float32),
        "w2": np.asarray(jnp.asarray(rng.standard_normal(like["w2"].shape),
                                     jnp.bfloat16)),
        "scale": np.float32(rng.standard_normal()),
    }


def patched(cur, **leaves):
    out = dict(cur)
    out.update(leaves)
    return out


def key_words(seed):
    """(the reference's PRNGKey(seed), the port's two key words)."""
    key = jax.random.PRNGKey(seed)
    return key, [int(w) for w in np.asarray(jax.random.key_data(key))[:2]]


class Pair:
    """One reference and one port Protector driven in lockstep on
    `small_state_np` (or `state` = (numpy leaves, specs)) at
    block_words = 64."""

    def __init__(self, mesh_name, mode, *, state=None, **kw):
        self.mesh, self.zmesh = jax_mesh(mesh_name), zone_mesh(mesh_name)
        self.cur, self.specs = small_state_np() if state is None else state
        ref_state = to_jax(self.cur, self.specs, self.mesh)
        self.ref = RefProtector(self.mesh, jax.eval_shape(lambda: ref_state),
                                jax_specs(self.specs), mode=RefMode(mode),
                                block_words=64, **kw)
        self.port = Protector(self.zmesh, to_torch(self.cur),
                              port_specs(self.specs), mode=Mode(mode),
                              block_words=64, **kw)
        self.rp = self.ref.init(ref_state)
        self.pp = self.port.init(self.zone(self.cur))
        self.check()

    def zone(self, state_np):
        ps = port_specs(self.specs)
        return {k: sharding.shard(v, ps[k], self.zmesh)
                for k, v in to_torch(state_np).items()}

    def check(self):
        assert_prot_same(self.rp, self.mesh, self.pp)

    def commit(self, new_np, *, seed=0, canary_ok=True, **kw):
        key, words = key_words(seed)
        self.rp, rok = self.ref.commit(
            self.rp, to_jax(new_np, self.specs, self.mesh), rng_key=key,
            data_cursor=seed + 1, canary_ok=canary_ok, **kw)
        self.pp, pok = self.port.commit(
            self.pp, self.zone(new_np), rng_key=words, data_cursor=seed + 1,
            canary_ok=canary_ok, **kw)
        assert bool(pok) == bool(rok)
        self.check()
        if bool(rok):
            self.cur = new_np
        return bool(rok)


def epoch_fields(est, mesh) -> dict:
    """The reference's EpochState as convert's epoch field dict (numpy)."""
    def arr(x):
        return None if x is None else np.asarray(x)
    return {"prot": ref_fields(est.prot, mesh), "dirty": arr(est.dirty),
            "pending": arr(est.pending), "acc": arr(est.acc)}


class EpochPair:
    """A reference and a port DeferredProtector over a `Pair`'s two
    Protectors (`window`, `dirty_leaf_idx`, `replicate_meta` for both,
    the rest for the Protectors), driven in lockstep; after every commit
    and flush the whole window — every protected field, the redo log, the
    accumulator, the dirty mask and the pending count — is byte-equal."""

    def __init__(self, mesh_name, mode, *, window, dirty_leaf_idx=None,
                 replicate_meta=False, **kw):
        self.pair = Pair(mesh_name, mode, **kw)
        eng = dict(window=window, dirty_leaf_idx=dirty_leaf_idx,
                   replicate_meta=replicate_meta)
        self.ref = RefDeferred(self.pair.ref, donate=False, **eng)
        self.port = DeferredProtector(self.pair.port, **eng)
        self.rest = self.ref.wrap(self.pair.rp)
        self.pest = self.port.wrap(self.pair.pp)
        self.check()

    @property
    def cur(self):
        return self.pair.cur

    def check(self):
        want = epoch_fields(self.rest, self.pair.mesh)
        got = convert.from_port_epoch(self.pest)
        assert_same(want["prot"], got["prot"])
        for k in ("dirty", "pending", "acc"):
            _same(want[k], got[k], k)
        assert self.ref._since == self.port._since
        assert self.ref.window == self.port.window

    def commit(self, new_np, *, seed=0, canary_ok=True, dirty_words=None):
        key, words = key_words(seed)
        pr = self.pair
        self.rest, rok = self.ref.commit(
            self.rest, to_jax(new_np, pr.specs, pr.mesh),
            dirty_words=dirty_words, data_cursor=seed + 1, rng_key=key,
            canary_ok=canary_ok)
        self.pest, pok = self.port.commit(
            self.pest, pr.zone(new_np), dirty_words=dirty_words,
            data_cursor=seed + 1, rng_key=words, canary_ok=canary_ok)
        assert bool(pok) == bool(rok)
        self.check()
        if bool(rok):
            pr.cur = new_np
        return bool(rok)

    def flush(self):
        self.rest = self.ref.flush(self.rest)
        self.pest = self.port.flush(self.pest)
        self.check()


# -- inputs and byte checks of the GF sweep tests -----------------------------

GF_SHAPES = [(1, 64), (13, 128), (16, 1024)]


def sweep_pages(n, bw, seed):
    """Seeded u32 (old, new) pages and the old pages' stored terms with a
    few rows corrupted."""
    old, new = rand_u32((n, bw), seed), rand_u32((n, bw), seed + 1)
    stored = np.asarray(ref.fletcher_blocks_ref(jnp.asarray(old))).copy()
    stored[::3, 0] ^= 1                    # a few corrupted stored rows
    return old, new, stored


def sweep_inputs(r, n, bw):
    """(torch, jax) forms of seeded (old, new, stored, one rank's
    coefficient row of a G = 100 zone) for the sweeps at r."""
    old, new, stored = sweep_pages(n, bw, seed=31 * r + n)
    co = ref_gf.syndrome_array(100, r)[99]
    return ([as_words(a) for a in (old, new, stored, co)],
            [jnp.asarray(a) for a in (old, new, stored, co)])


def eq_words(got, *wants):
    got = words(got) if got.dtype == torch.int32 else got.numpy()
    for want in wants:
        np.testing.assert_array_equal(got, np.asarray(want))


def check_outputs(got, *wants):
    for outs in zip(got, *wants, strict=True):
        eq_words(*outs)


class _F32Dots:
    """`jax.numpy` with `einsum` taking a `preferred_element_type=float32`
    product of bf16 operands in f32: the operands widened (exactly) and
    multiplied in f32, the function the reference asks for.  XLA's CPU
    backend runs no batched bf16 x bf16 -> f32 dot (the mLSTM's per-head
    and the experts' products), so the reference's modules reach it
    through this stand-in on the CPU (`f32_dots`)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) for o in ops]
        return jnp.einsum(spec, *ops,
                          preferred_element_type=preferred_element_type,
                          **kw)


def f32_dots(monkeypatch, *modules) -> None:
    """Point each reference module's `jnp` at `_F32Dots` for a test."""
    for m in modules:
        monkeypatch.setattr(m, "jnp", _F32Dots())


def allclose(got: torch.Tensor, want, rtol: float = 1e-5,
             atol: float = 1e-6) -> None:
    """Elementwise |got - want| <= atol + rtol |want|."""
    want = np.asarray(jnp.asarray(want, jnp.float32)).astype(np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want) - rtol * np.abs(want)
    assert float(err.max()) <= atol, float(err.max())


_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs",
               "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(scope="module")
def compile_cache(tmp_path_factory):
    """For a module's tests, keep the reference's compiled XLA programs in
    the session's temporary directory: each reference Server and Trainer
    jit-compiles its decode, commit and scrub programs anew, the same
    programs from one test to the next.  A cache hit skips XLA's compile
    only; tracing and results are unchanged.  The settings come back
    after the module.  Use with `pytestmark =
    pytest.mark.usefixtures("compile_cache")`."""
    saved = [jax.config.values[k] for k in _CACHE_KEYS]
    for k, v in zip(_CACHE_KEYS, (
            str(tmp_path_factory.getbasetemp() / "jax_cache"), 0.0, 0)):
        jax.config.update(k, v)
    yield
    for k, v in zip(_CACHE_KEYS, saved):
        jax.config.update(k, v)


@pytest.fixture(scope="module")
def one_thread():
    """For a module's tests, torch's CPU ops on one thread.  Under several
    pytest workers sharing the cores, torch's intra-op threads wait on
    each other, and a port server's r = 3, window 4 generation at
    reduced width runs many times slower than on one thread (alone the
    two are alike).  The setting comes back after the module.  Use with `pytestmark =
    pytest.mark.usefixtures("one_thread")`."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
