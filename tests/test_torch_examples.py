"""The port's examples (examples/torch_*.py) on the CPU: each one's
`main([..., "--device", "cpu"])` runs with its own asserts (the
quickstart in full, the others their --smoke pass), and the serving
example's tokens are the reference's Server's on the same weights,
converted to the reference, token for token.  The training example
against the reference's Trainer is in test_torch_examples_train.py."""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import ProtectConfig as RefProtectConfig
from repro.runtime.server import Server as RefServer
from repro_torch import convert, utils
from tests import _torch_ref as tr
from tests._torch_ref import compile_cache, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("compile_cache", "one_thread")

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs(capsys):
    example("torch_quickstart").main(["--device", "cpu"])
    assert "all quickstart checks passed" in capsys.readouterr().out


def test_serve_example_gives_the_references_tokens(capsys):
    ex = example("torch_serve_protected")
    got = ex.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "faulted generation matches reference bit-for-bit" in out
    tokens, prompt = got["tokens"], got["prompt"].numpy()
    assert tokens.shape == (4, 16)
    fields = {k: getattr(ex.CONFIG, k) for k in (
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv", "d_ff",
        "vocab", "param_dtype", "compute_dtype")}
    mesh = tr.jax_mesh("mesh42")
    ref = RefServer(RefModelConfig(**fields),
                    RefProtectConfig(mode="mlpc", block_words=256), mesh,
                    batch=4, max_len=16 + 16)
    ref.start(jax.tree.map(jnp.asarray,
                           utils.tree_map(convert._np_leaf, got["params"])))
    want = ref.generate(jnp.asarray(prompt.astype(np.int32)), n_new=16)
    np.testing.assert_array_equal(tokens, want)


def test_elastic_example_runs(capsys):
    losses = example("torch_elastic_rescale").main(["--smoke", "--device",
                                                    "cpu"])
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert "elastic rescale demo passed: 12 contiguous steps across 3 " \
        "meshes" in capsys.readouterr().out


def test_examples_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, argv in (("torch_quickstart", []),
                       ("torch_serve_protected", ["--smoke"]),
                       ("torch_train_fault_tolerant", ["--smoke"]),
                       ("torch_elastic_rescale", ["--smoke"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example(name).main(argv)
