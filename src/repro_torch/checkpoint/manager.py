"""Async disk checkpointing — the backstop tier below in-memory parity
(the reference's checkpoint/manager.py, in its on-disk format).

Tier-0 (the pool) repairs rank loss and scribbles from parity in seconds.
Tier-1 (this module) covers correlated failures that defeat parity:
versioned, digest-verified, atomically-renamed checkpoints written by a
background thread, so the train loop does not wait on the disk.

Format, shared with the reference so that a checkpoint written by one
package restores in the other: `<dir>/step_<n>/{manifest.json,
arrays.npz}`.  `arrays.npz` holds each leaf of the global state under the
reference's key string (JAX's `keystr`: `"['params']['embed']['tok']"`);
the manifest holds the step, the time, a Fletcher digest a leaf (checked
on restore) and the `extra` dict, JSON-encoded as the reference encodes
it: a numpy array as {"__ndarray__", "dtype", "shape"}, a redo log as
{"__pytree__": "RedoLog", "children": [its five u32 fields]}.  A bf16 leaf
(numpy has no bf16) is stored as its uint16 bits and named in the
manifest's "bf16" list.

`save` sums the digests where the state lies and copies it to the host
before it returns; only the write runs on the thread.  `restore` checks
each leaf's digest on the device it restores to.  `restore` returns global tensors on the manager's
device (the card unless the caller asks for the CPU), in the tree of
`state_specs` when the manager has one, else a flat dict by key.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import utils
from repro_torch.core import redolog

PyTree = Any

_M32 = 0xFFFFFFFF
_DIGEST_CHUNK = 1 << 24           # words a pass
_LOG_FIELDS = ("step", "data_cursor", "rng", "digest", "mark")


def _digest(x) -> list:
    """The reference's per-leaf Fletcher digest [A, B] of the leaf's bytes
    as u32 words (zero-padded to a word): A = sum w_i, B = sum (n - i) w_i,
    both mod 2^32.  `x`: a tensor (summed where it lies, on the card for a
    train state) or a numpy array.  Summed in chunks of int64 words: the
    reference's uint64 temporaries of a whole leaf would take 8 bytes a
    word."""
    if isinstance(x, torch.Tensor):
        raw = x.detach().contiguous().reshape(-1).view(torch.uint8)
    else:
        raw = torch.from_numpy(np.ascontiguousarray(x).reshape(-1).view(
            np.uint8))
    if raw.numel() % 4:
        raw = torch.nn.functional.pad(raw, (0, 4 - raw.numel() % 4))
    w = raw.view(torch.int32)
    n = w.numel()
    a = b = 0
    for lo in range(0, n, _DIGEST_CHUNK):
        c = utils.as_u64(w[lo:lo + _DIGEST_CHUNK])
        weights = (n - torch.arange(lo, lo + c.numel(), device=c.device)) \
            & _M32
        a = (a + int(utils.sum32(c))) & _M32
        b = (b + int(utils.sum32(utils.mul32(c, weights)))) & _M32
    return [a, b]


def _flatten_with_paths(tree: PyTree, prefix: str = "") -> dict:
    """{key string: leaf}, keys as JAX's `keystr` spells them, dict keys
    sorted as JAX orders them (a spec `P` is a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten_with_paths(tree[k], f"{prefix}[{k!r}]"))
        return out
    if type(tree) in (list, tuple):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flatten_with_paths(t, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _host(x) -> np.ndarray:
    """A tensor (or array) as a host numpy array; bf16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy().view(np.uint16)
        return x.cpu().numpy()
    return np.asarray(x)


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, redolog.RedoLog):
        # the reference's RedoLog pytree: its five u32 fields in order
        return {"__pytree__": "RedoLog", "children": [
            _jsonable(_host(getattr(x, f)).view(np.uint32))
            for f in _LOG_FIELDS]}
    if isinstance(x, torch.Tensor):
        x = _host(x)
    if isinstance(x, np.ndarray):
        return {"__ndarray__": x.tolist(), "dtype": str(x.dtype),
                "shape": list(x.shape)}
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    return x


def log_from_extra(log, device) -> redolog.RedoLog:
    """A redo log from a manifest's `extra["log"]` (the reference's
    {"__pytree__": "RedoLog", "children": [...]} form) or a live RedoLog,
    as int32 words on `device`."""
    if isinstance(log, redolog.RedoLog):
        return redolog.RedoLog(**{f: getattr(log, f).to(device)
                                  for f in _LOG_FIELDS})

    def words(c):
        a = np.asarray(c["__ndarray__"], dtype=c["dtype"]).reshape(
            c["shape"])
        return torch.from_numpy(
            a.astype(np.uint32).view(np.int32).copy()).to(device)
    return redolog.RedoLog(*[words(c) for c in log["children"]])


class CheckpointManager:
    def __init__(self, directory: str, mesh=None, state_specs: PyTree = None,
                 keep: int = 3, device=None):
        self.directory = directory
        self.mesh = mesh
        self.state_specs = state_specs
        self.keep = keep
        self.device = utils.resolve_device(device)
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save -----------------------------------------------------------------

    def save(self, step: int, state: PyTree, extra: Optional[dict] = None,
             blocking: bool = False) -> None:
        self.wait()
        flat = _flatten_with_paths(state)
        bf16 = sorted(k for k, v in flat.items()
                      if isinstance(v, torch.Tensor)
                      and v.dtype == torch.bfloat16)
        digests = {k: _digest(v) for k, v in flat.items()}
        host = {k: _host(v) for k, v in flat.items()}
        extra_json = _jsonable(extra or {})

        def _write():
            try:
                tmp = os.path.join(self.directory, f".tmp_step_{step}")
                final = os.path.join(self.directory, f"step_{step}")
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, "arrays.npz"), **host)
                manifest = {
                    "step": step,
                    "time": time.time(),
                    "digests": digests,
                    "extra": extra_json,
                }
                if bf16:
                    manifest["bf16"] = bf16
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)   # atomic publish
                self._gc()
            except BaseException as e:  # noqa: BLE001
                self._error = e

        if blocking:
            _write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint failed: {e}") from e

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def list_steps(self) -> list:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_"):
                out.append(int(d.split("_", 1)[1]))
        return sorted(out)

    def restore(self, step: int, template: PyTree = None,
                state_specs: PyTree = None) -> tuple:
        """(state, extra) of checkpoint `step`, every leaf's digest checked;
        `template` (tensors or arrays) checks the leaves' shapes."""
        d = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        bf16 = set(manifest.get("bf16", ()))
        want = ({k: tuple(v.shape)
                 for k, v in _flatten_with_paths(template).items()}
                if template is not None else {})
        arrays = {}
        with np.load(os.path.join(d, "arrays.npz")) as npz:
            for k in npz.files:
                arr = np.asarray(npz[k], order="C")    # keeps a 0-d leaf 0-d
                if k in want and tuple(arr.shape) != want[k]:
                    raise ValueError(
                        f"checkpoint step {step} leaf {k} has shape "
                        f"{arr.shape}, expected {want[k]} — restoring a "
                        "checkpoint from a different model configuration?")
                # bf16: the port's uint16 bits, or the reference's
                # ml_dtypes bfloat16, which loads as 2-byte void
                t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                     if k in bf16 or arr.dtype.kind == "V"
                     else torch.from_numpy(arr)).to(self.device)
                # the digest is of the bytes, summed on the device
                if _digest(t) != manifest["digests"][k]:
                    raise RuntimeError(f"checkpoint digest mismatch for {k}")
                arrays[k] = t
        specs = state_specs if state_specs is not None else self.state_specs
        if specs is not None:
            leaves, treedef = utils.tree_flatten(specs)
            keys = list(_flatten_with_paths(specs))
            state = utils.tree_unflatten(treedef, [arrays[k] for k in keys])
        else:
            state = arrays
        return state, manifest.get("extra", {})

    def restore_latest(self) -> tuple:
        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        step = steps[-1]
        state, extra = self.restore(step)
        return step, state, extra
