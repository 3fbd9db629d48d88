"""Carry protected state between the reference's numpy view and the port.

The input side is plain numpy, so this module needs neither JAX nor the
reference package.  A protected state travels as a dict of fields:

    state    pytree of zone-stacked leaves, (*mesh_dims, *local_shape):
             the per-device shards ordered by their device's position in
             the mesh (bf16 as ml_dtypes.bfloat16 or as uint16 bits)
    replica  the same, or None
    synd, cksums, digest, row
             u32 arrays with the mesh dims leading (the reference's global
             arrays already have this shape), or None
    log      dict of the redo log's u32 fields, or None
    step     u32 scalar

`to_port` builds the port's `ProtectedState` from such a dict;
`from_port` gives the dict back, with words as uint32 and bf16 leaves as
their uint16 bits, so two states compare with `tobytes()`.

An open deferred window travels as {"prot": such a dict, "dirty": bool
mask (*mesh_dims, n_blocks) or None, "pending": u32 scalar, "acc": u32
(*mesh_dims, row_words) or None}: `to_port_epoch` / `from_port_epoch`.
A window opened in the reference then continues in the port (hand the
port's engine the state through `DeferredProtector.resume`).

`params_to_port` carries a model's parameter tree the same way, and
`train_state_to_port` a trainer's {"params", "opt", "step"} (a KV cache
is protected state and travels through `to_port`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import utils
from repro_torch.core import redolog
from repro_torch.core.epoch import EpochState
from repro_torch.core.txn import ProtectedState

_LOG_FIELDS = ("step", "data_cursor", "rng", "digest", "mark")
_WORD_FIELDS = ("synd", "cksums", "digest", "row")


def _words(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    a = np.array(a, dtype=np.uint32, order="C")      # a copy; keeps 0-d
    return torch.from_numpy(a.view(np.int32)).to(device)


def _leaf(a, device) -> torch.Tensor:
    a = np.array(a, order="C")                        # a copy; keeps 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_port(fields: dict, device=None) -> ProtectedState:
    """Reference fields (numpy) -> the port's ProtectedState on `device`
    (the card unless the caller asks for the CPU)."""
    device = utils.resolve_device(device)
    log = fields.get("log")
    replica = fields.get("replica")
    return ProtectedState(
        state=utils.tree_map(lambda a: _leaf(a, device), fields["state"]),
        synd=_words(fields.get("synd"), device),
        cksums=_words(fields.get("cksums"), device),
        digest=_words(fields.get("digest"), device),
        replica=(None if replica is None else
                 utils.tree_map(lambda a: _leaf(a, device), replica)),
        log=(None if log is None else redolog.RedoLog(
            **{k: _words(log[k], device) for k in _LOG_FIELDS})),
        step=_words(fields["step"], device).reshape(()),
        row=_words(fields.get("row"), device))


def _np_words(t: Optional[torch.Tensor]):
    return None if t is None else t.cpu().numpy().view(np.uint32)


def _np_leaf(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def params_to_port(np_params, device=None):
    """The reference's parameter tree (numpy; bf16 as ml_dtypes.bfloat16)
    -> the port's tensors on `device` (the card unless the caller asks
    for the CPU), bit for bit."""
    device = utils.resolve_device(device)
    return utils.tree_map(lambda a: _leaf(a, device), np_params)


def train_state_to_port(ref_state_np: dict, device=None) -> dict:
    """The reference's train state (numpy): params, either optimizer's
    moment tree (AdamW's {"m", "v"}, Adafactor's per-parameter {"v"} or
    {"vr", "vc"}) and the int32 step -> the port's tensors on `device`,
    bit for bit."""
    device = utils.resolve_device(device)
    return {"params": params_to_port(ref_state_np["params"], device),
            "opt": params_to_port(ref_state_np["opt"], device),
            "step": _leaf(np.asarray(ref_state_np["step"], np.int32),
                          device)}


def from_port(prot: ProtectedState) -> dict:
    """The port's ProtectedState -> the field dict above (numpy)."""
    out = {k: _np_words(getattr(prot, k)) for k in _WORD_FIELDS}
    out["state"] = utils.tree_map(_np_leaf, prot.state)
    out["replica"] = (None if prot.replica is None
                      else utils.tree_map(_np_leaf, prot.replica))
    out["log"] = (None if prot.log is None else
                  {k: _np_words(getattr(prot.log, k)) for k in _LOG_FIELDS})
    out["step"] = _np_words(prot.step)
    return out


def to_port_epoch(fields: dict, device=None) -> EpochState:
    """A reference EpochState's fields (numpy) -> the port's EpochState."""
    device = utils.resolve_device(device)
    dirty = fields.get("dirty")
    return EpochState(
        prot=to_port(fields["prot"], device),
        dirty=(None if dirty is None else
               torch.from_numpy(np.array(dirty, dtype=bool)).to(device)),
        pending=_words(fields["pending"], device).reshape(()),
        acc=_words(fields.get("acc"), device))


def from_port_epoch(est: EpochState) -> dict:
    """The port's EpochState -> the field dict above (numpy)."""
    return {"prot": from_port(est.prot),
            "dirty": None if est.dirty is None else est.dirty.cpu().numpy(),
            "pending": _np_words(est.pending), "acc": _np_words(est.acc)}
