"""Checkpointing (port of ``repro.checkpoint.store``): a tree <-> a
directory of ``.npy`` leaves and a JSON manifest, in the reference's
format.

A leaf's key is the reference's ``jax.tree_util`` key path of the same
tree, written here without JAX: dict keys and list indices joined by
``/`` (``layers/wq``, ``mlstm_runs/0/w_up``), a named tuple's fields by
name; a ``None`` entry is an empty node and stores nothing.  So either
package restores what the other saved.  bfloat16 leaves go to disk as
two-byte records (numpy has no bfloat16: the reference's files hold
``|V2``) with ``"dtype": "bfloat16"`` in the manifest.

``restore`` fills the structure of ``like``: numpy leaves where ``like``
has numpy leaves, tensors of ``like``'s dtype on ``like``'s device where
it has tensors.  ``restore_params`` reads a merged model's checkpoint
(the reference's tree, as ``repro.checkpoint.store.save`` wrote it) into
the port's layout through ``checkpoint/bridge.py``.
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.models.common import MergedParams


def _map(fn, tree: Any, prefix: tuple = ()):
    """``tree`` with each leaf replaced by ``fn(key path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, MergedParams):
        tree = tree.tree()
    if isinstance(tree, dict):
        return {k: _map(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, getattr(tree, n), prefix + (n,)) for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, prefix + (str(i),)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def _key_str(path: tuple) -> str:
    return "/".join(path)


def _fname(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to write, manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(path: str | Path, tree: Any, *, extra: dict | None = None) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    manifest = {"leaves": {}, "extra": extra or {}}

    def write(keypath, leaf):
        key = _key_str(keypath)
        arr, dtype = _to_numpy(leaf)
        np.save(path / _fname(key), arr)
        manifest["leaves"][key] = {"file": _fname(key), "shape": list(arr.shape),
                                   "dtype": dtype}

    _map(write, tree)
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))


def _load(path: Path, info: dict):
    """A leaf as written: numpy, or a bfloat16 tensor (numpy has none)."""
    arr = np.load(path / info["file"])
    if info["dtype"] == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return arr


def restore(path: str | Path, like: Any, *, faults=None) -> Any:
    """Restore into the structure of ``like`` (leaves with ``.shape`` and
    ``.dtype``: numpy arrays or tensors).  ``faults`` is an optional
    armed :class:`~repro_torch.serving.resilience.faults.FaultInjector`;
    its ``checkpoint`` site fires before the manifest is read."""
    if faults is not None and faults.armed:
        faults.on_call("checkpoint")
    path = Path(path)
    leaves = json.loads((path / "manifest.json").read_text())["leaves"]

    def load(keypath, leaf):
        key = _key_str(keypath)
        if key not in leaves:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = _load(path, leaves[key])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} != "
                             f"expected {tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
            return t.to(device=leaf.device, dtype=leaf.dtype)
        if isinstance(arr, torch.Tensor):
            arr = arr.float().numpy()
        return arr.astype(leaf.dtype, copy=False)

    return _map(load, like)


def restore_params(path: str | Path, cfg, like, device, *, faults=None) -> MergedParams:
    """A merged model's checkpoint in the port's layout and storage dtypes.
    ``like`` gives the reference's tree structure: the port's own
    ``MergedParams`` of the same config, or the reference tree itself."""
    shapes = _map(lambda _, t: np.lib.stride_tricks.as_strided(
        np.zeros((), np.float32), tuple(t.shape), (0,) * len(t.shape)), like)
    tree = restore(path, shapes, faults=faults)
    return params_from_numpy(cfg, tree, device)
