"""Shared utilities of the fusion-aware model zoo (port of
``repro.models.common``).

Conventions, as in the reference:

* every parameter tensor carries a leading ``instances`` axis ``M``
  (NetFuse-merged fine-tuned instances; M=1 is the plain model),
* layer stacks are stacked along a leading ``L`` axis, so leaves under
  ``"layers"`` are ``(L, M, ...)`` and top-level leaves ``(M, ...)``,
* activations are ``(M, B, ...)``,
* serving caches are grid trees whose leaves are
  ``(L, M, B, S_cache, KVH, hd)``: instances on axis 1, batch on axis 2,
  context on axis 3.

The reference threads logical-axes trees through these helpers for its
sharding rules; the port is single-device, so the instance/batch axes
follow from the two layouts above.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

import torch
from torch import nn

# grid cache leaves: (L, M, B, S_cache, ...)
CACHE_SEQ_AXIS = 3


# ---------------------------------------------------------------------------
# parameter factory (the distributions of the reference's Factory)
# ---------------------------------------------------------------------------


class Factory:
    """Creates parameter tensors from an explicit ``torch.Generator``.

    Draws the reference's distributions (``models/common.py`` Factory):
    ``normal`` is N(0, 1)·scale, ``fan_in`` N(0, 1)/sqrt(shape[-2]),
    ``ones`` and ``zeros`` are constants.  torch's and JAX's generators
    give different numbers from one seed, so tests that compare the two
    packages carry JAX's weights across with ``checkpoint.bridge``."""

    def __init__(self, generator: torch.Generator | None, dtype: torch.dtype,
                 device: torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = device

    def __call__(self, shape: Sequence[int], *, init: str = "normal",
                 scale: float = 0.02) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        kw = dict(dtype=self.dtype, device=self.device)
        if init == "zeros":
            return torch.zeros(shape, **kw)
        if init == "ones":
            return torch.ones(shape, **kw)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        if init == "normal":
            s = scale if scale else 1.0 / math.sqrt(fan_in)
        elif init == "fan_in":
            s = 1.0 / math.sqrt(fan_in)
        else:
            raise ValueError(init)
        v = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return (v * s).to(self.dtype)


# ---------------------------------------------------------------------------
# the merged model: an nn.Module keeping the reference's leaf names
# ---------------------------------------------------------------------------


class MergedParams(nn.Module):
    """Parameters of M merged instances under the reference's leaf names
    and layouts (``embed``, ``layers.wq``, ``final_norm``, ...).

    Subscripting mirrors the reference's dict tree
    (``params["layers"]["wq"]``), so the model math is written once over
    plain tensors.  Nothing in serving needs a gradient."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, (dict, MergedParams)):
                self.add_module(name, leaf if isinstance(leaf, MergedParams)
                                else MergedParams(leaf))
            else:
                self.register_parameter(
                    name, nn.Parameter(leaf, requires_grad=False))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        return self._modules[name]

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def keys(self) -> list[str]:
        return [*self._parameters, *self._modules]

    def get(self, name: str, default=None):
        return self[name] if name in self else default

    def tree(self) -> dict:
        """Plain nested dict of the parameter tensors."""
        out: dict[str, Any] = {k: v.data for k, v in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


def _as_tree(params) -> dict:
    return params.tree() if isinstance(params, MergedParams) else params


def _map_params(fn, *trees, _layered: bool = False):
    """Map ``fn(leaves..., inst_axis)`` over parameter trees."""
    out = {}
    for k, v in trees[0].items():
        if isinstance(v, dict):
            out[k] = _map_params(fn, *(t[k] for t in trees),
                                 _layered=_layered or k == "layers")
        else:
            out[k] = fn(*(t[k] for t in trees), 1 if _layered else 0)
    return out


def merge_instances(params_list: list) -> MergedParams:
    """NetFuse-merge M single-instance checkpoints into one merged model:
    every leaf is concatenated along its instances axis (axis 1 for the
    layer-stacked leaves, axis 0 for the rest)."""
    trees = [_as_tree(p) for p in params_list]
    return MergedParams(_map_params(
        lambda *ls: torch.cat(ls[:-1], dim=ls[-1]), *trees))


def gather_instances(params, idx) -> MergedParams:
    """Gather instance rows ``idx`` (k,) into a model whose instances axis
    is k.  This copies every weight; the serving prefill uses per-lane
    views (``instances=`` of ``dense.prefill_chunk``) instead."""
    tree = _as_tree(params)
    any_leaf = tree["final_norm"]
    idx = torch.as_tensor(idx, dtype=torch.long, device=any_leaf.device)
    return MergedParams(_map_params(
        lambda l, ax: l.index_select(ax, idx), tree))


# ---------------------------------------------------------------------------
# lane / slot surgery on grid trees (caches)
# ---------------------------------------------------------------------------


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in _leaves(v)]
    return [l for v in tree for l in _leaves(v)]


def tree_map(fn, *trees):
    """Map over matching tensors of dicts / NamedTuples / tuples."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    vals = [tree_map(fn, *xs) for xs in zip(*trees)]
    return type(t0)(*vals) if hasattr(t0, "_fields") else type(t0)(vals)


def tree_select_lanes(mask: torch.Tensor, new_tree, old_tree):
    """Lane k (along each grid leaf's instances axis) takes ``new_tree``
    where ``mask[k]``, else keeps ``old_tree``."""
    def _sel(n, o):
        mk = mask.reshape((1, mask.shape[0]) + (1,) * (n.ndim - 2))
        return torch.where(mk, n, o)
    return tree_map(_sel, new_tree, old_tree)


def tree_select_slots(mask: torch.Tensor, new_tree, old_tree):
    """Slot (m, b) takes ``new_tree`` where ``mask[m, b]``, else keeps
    ``old_tree``."""
    def _sel(n, o):
        mk = mask.reshape((1,) + tuple(mask.shape) + (1,) * (n.ndim - 3))
        return torch.where(mk, n, o)
    return tree_map(_sel, new_tree, old_tree)


def tree_take_slot(tree, m: int, b: int):
    """Slot (m, b) of every grid leaf, singleton dims kept (a view)."""
    return tree_map(lambda l: l[:, m:m + 1, b:b + 1], tree)


def tree_put_slot(grid, one, m: int, b: int):
    """Write a single-slot tree into grid slot (m, b), in place.  A
    source whose context axis is longer or shorter than the grid's is
    prefix-clipped, as in the reference.  Returns ``grid``."""
    def _put(g, o):
        s = min(o.shape[CACHE_SEQ_AXIS], g.shape[CACHE_SEQ_AXIS])
        g[:, m:m + 1, b:b + 1, :s].copy_(o[:, :, :, :s])
        return g
    tree_map(_put, grid, one)
    return grid
