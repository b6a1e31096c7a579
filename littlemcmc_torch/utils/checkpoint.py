"""Checkpoint/resume of the full sampler state.

Counterpart of ``littlemcmc_tpu/utils/checkpoint.py`` (Orbax there): the
state is written with ``torch.save`` as a payload of plain dicts, lists,
tensors, numbers and strings, which ``torch.load(..., weights_only=True)``
reads back; no class is pickled. The payload holds everything that makes
the continuation exact:

- the :class:`~littlemcmc_torch.base.ChainState`'s tensors (positions,
  cached gradients and log densities, iteration counters) and its
  dual-averaging state;
- the batched metric's fields and its class name, restored through a
  table of the port's metric classes (:data:`_CLASSES`);
- ``extra``: what the caller adds, e.g. ``sample()``'s device generator
  state and the fused runner's two seed words.

Each checkpoint is a directory ``step_%08d`` under the checkpoint
directory holding ``state.pt`` and the JSON meta file; it is written under
a temporary name and renamed into place, so :func:`latest_checkpoint`
never sees half of one.

Under a mesh (``group``, the chain dimension's process group; JAX's
``utils/checkpoint.py:10-14, 67-76``) every rank writes its own rows as
``state_rank%d.pt`` into one temporary step directory on a filesystem that
all ranks share; after a barrier rank 0 writes the meta file (with the rank
count) and renames the directory into place, and a second barrier holds
every rank until it is there. A resume restores each rank's file and
refuses a checkpoint of another rank count.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import torch

from ..base import ChainState
from ..parallel.distributed import barrier, group_rank_size
from ..quadpotential import (QuadPotentialDiag, QuadPotentialDiagAdapt, QuadPotentialFull,
                             QuadPotentialFullAdapt, QuadPotentialFullInv,
                             QuadPotentialLowRankAdapt, WelfordCovariance, WelfordVariance)
from ..step_sizes import DualAverageState

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint"]

_META_NAME = "littlemcmc_torch_meta.json"
_STATE_NAME = "state.pt"
_FORMAT = 1

# the classes a payload may name
_CLASSES = {cls.__name__: cls for cls in (
    QuadPotentialDiag, QuadPotentialDiagAdapt, QuadPotentialFull, QuadPotentialFullAdapt,
    QuadPotentialFullInv, QuadPotentialLowRankAdapt, WelfordVariance, WelfordCovariance,
    DualAverageState)}


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step:08d}")


def _pack(x):
    """A dataclass of the table as ``{"class": name, "fields": {...}}``,
    tensors detached onto the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if dataclasses.is_dataclass(x):
        name = type(x).__name__
        if _CLASSES.get(name) is not type(x):
            raise TypeError(f"cannot checkpoint a {name}: not one of the port's metric "
                            f"classes ({', '.join(sorted(_CLASSES))})")
        return {"class": name,
                "fields": {f.name: _pack(getattr(x, f.name)) for f in dataclasses.fields(x)}}
    if isinstance(x, dict):
        return {k: _pack(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_pack(v) for v in x]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _unpack(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict) and set(x) == {"class", "fields"}:
        cls = _CLASSES[x["class"]]
        return cls(**{k: _unpack(v, device) for k, v in x["fields"].items()})
    if isinstance(x, dict):
        return {k: _unpack(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [_unpack(v, device) for v in x]
    return x


def _state_name(group) -> str:
    rank, size = group_rank_size(group)
    return _STATE_NAME if size == 1 else f"state_rank{rank}.pt"


def save_checkpoint(directory: str, state: ChainState, step: int,
                    meta: Optional[Dict[str, Any]] = None,
                    extra: Optional[Dict[str, Any]] = None, group=None) -> str:
    """Snapshot ``state`` (and JSON ``meta``, and the tensors and numbers
    of ``extra``) as checkpoint ``step`` under ``directory``; returns its
    path. An existing checkpoint of that step is replaced. ``group``: every
    rank of it calls this with its own rows (the module docstring)."""
    path = _ckpt_path(directory, step)
    payload = {
        "format": _FORMAT,
        "state": {"q": _pack(state.q), "q_grad": _pack(state.q_grad),
                  "logp": _pack(state.logp), "iter_count": _pack(state.iter_count),
                  "da": _pack(state.da), "potential": _pack(state.potential)},
        "extra": _pack(extra or {}),
    }
    parent = os.path.dirname(path)
    rank, size = group_rank_size(group)
    if size > 1:
        return _save_sharded(payload, path, step, meta, group, rank, size)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp_step_", dir=parent)
    try:
        torch.save(payload, os.path.join(tmp, _STATE_NAME))
        with open(os.path.join(tmp, _META_NAME), "w") as f:
            json.dump({"step": int(step), **(meta or {})}, f)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def _save_sharded(payload, path: str, step: int, meta, group, rank: int, size: int) -> str:
    """Every rank's file into one temporary directory, then rank 0's
    rename into place, between barriers."""
    tmp = os.path.join(os.path.dirname(path), f".tmp_step_{step:08d}")
    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    barrier(group)
    torch.save(payload, os.path.join(tmp, _state_name(group)))
    barrier(group)
    if rank == 0:
        with open(os.path.join(tmp, _META_NAME), "w") as f:
            json.dump({"step": int(step), "ranks": size, **(meta or {})}, f)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    barrier(group)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """The most recent ``step_*`` checkpoint path in ``directory``, or None."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and os.path.isdir(os.path.join(directory, d)))
    return os.path.join(directory, steps[-1]) if steps else None


def restore_checkpoint(path: str, template: Optional[ChainState] = None, device=None,
                       group=None):
    """Restore a state saved by :func:`save_checkpoint`; returns ``(state,
    meta)``, ``meta`` the JSON meta with the payload's ``extra`` under
    ``"extra"``.

    The tensors go to ``device``, else to ``template``'s device (the CPU
    without either). ``template`` (e.g. a freshly initialized state) is
    checked against the checkpoint: the same metric class and the same
    position shape, else ``ValueError``. ``group``: this rank's file of a
    checkpoint of as many ranks."""
    size = group_rank_size(group)[1]
    meta = {}
    meta_file = os.path.join(path, _META_NAME)
    if os.path.exists(meta_file):
        with open(meta_file) as f:
            meta = json.load(f)
    if int(meta.get("ranks", 1)) != size:
        raise ValueError(f"{path} was written by {meta.get('ranks', 1)} rank(s); this run has "
                         f"{size}")
    payload = torch.load(os.path.join(path, _state_name(group)), map_location="cpu",
                         weights_only=True)
    if payload.get("format") != _FORMAT:
        raise ValueError(f"{path}: not a littlemcmc_torch checkpoint of format {_FORMAT}")
    if device is None:
        device = template.q.device if template is not None else torch.device("cpu")
    s = payload["state"]
    state = ChainState(q=_unpack(s["q"], device), q_grad=_unpack(s["q_grad"], device),
                       logp=_unpack(s["logp"], device), potential=_unpack(s["potential"], device),
                       da=_unpack(s["da"], device), iter_count=_unpack(s["iter_count"], device))
    if template is not None:
        if type(state.potential) is not type(template.potential):
            raise ValueError(f"{path} holds a {type(state.potential).__name__} metric; this "
                             f"run has a {type(template.potential).__name__}")
        if tuple(state.q.shape) != tuple(template.q.shape):
            raise ValueError(f"{path} holds positions of shape {tuple(state.q.shape)}; this "
                             f"run has {tuple(template.q.shape)}")
    meta["extra"] = _unpack(payload.get("extra", {}), "cpu")
    return state, meta
