"""Shared utilities of the fusion-aware model zoo (port of
``repro.models.common``).

Conventions, as in the reference:

* every parameter tensor carries a leading ``instances`` axis ``M``
  (NetFuse-merged fine-tuned instances; M=1 is the plain model),
* layer stacks are stacked along a leading ``L`` axis, so leaves under
  ``"layers"`` are ``(L, M, ...)`` and top-level leaves ``(M, ...)``,
* activations are ``(M, B, ...)``,
* serving caches and recurrent states are grid trees whose leaves carry
  the instances and batch dims side by side; a logical-axes tree names
  them (and the context dim, where there is one) on every leaf, as in
  the reference.  The port is single-device, so the axes trees drive
  slot and lane surgery only, not sharding.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

import torch
from torch import nn

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

    Subscripting mirrors the reference's tree (``params["layers"]["wq"]``,
    ``params["mlstm_runs"][0]["w_up"]``; lists and ``None`` entries as in
    the ssm tree), so the model math is written once over plain tensors.
    Nothing in serving needs a gradient."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, leaf in tree.items():
            self._add(name, leaf)

    def _add(self, name: str, leaf) -> None:
        if leaf is None or isinstance(leaf, MergedParams):
            self.add_module(name, leaf)
        elif isinstance(leaf, dict):
            self.add_module(name, MergedParams(leaf))
        elif isinstance(leaf, list):
            self.add_module(name, MergedList(leaf))
        else:
            self.register_parameter(name, nn.Parameter(leaf, requires_grad=False))

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
        out.update({k: None if m is None else m.tree() for k, m in self._modules.items()})
        return out


class MergedList(MergedParams):
    """A list node of the parameter tree (entries may be ``None``)."""

    def __init__(self, items: list):
        super().__init__({str(i): v for i, v in enumerate(items)})

    def __getitem__(self, i: int):
        return super().__getitem__(str(i))

    def __len__(self) -> int:
        return len(self._modules) + len(self._parameters)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def tree(self) -> list:
        t = super().tree()
        return [t[str(i)] for i in range(len(self))]


def _as_tree(params) -> dict:
    return params.tree() if isinstance(params, MergedParams) else params


# subtrees whose leaves are stacked on a leading layer axis (L, M, ...)
_LAYER_STACKED = ("layers", "mlstm_runs")


def _map_params(fn, *trees, _inst: int = 0):
    """Map ``fn(leaves..., inst_axis)`` over parameter trees."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: _map_params(fn, *(t[k] for t in trees),
                               _inst=1 if k in _LAYER_STACKED else _inst)
                for k in t0}
    if isinstance(t0, list):
        return [_map_params(fn, *xs, _inst=_inst) for xs in zip(*trees)]
    return fn(*trees, _inst)


def merge_instances(params_list: list) -> MergedParams:
    """NetFuse-merge M single-instance checkpoints into one merged model:
    every leaf is concatenated along its instances axis (axis 1 for the
    layer-stacked leaves, axis 0 for the rest)."""
    trees = [_as_tree(p) for p in params_list]
    return MergedParams(_map_params(
        lambda *ls: torch.cat(ls[:-1], dim=ls[-1]), *trees))


def instance_views(params, start: int, n: int = 1) -> MergedParams:
    """Instances ``start .. start + n`` of a merged model as a model of n
    instances whose leaves are views of the merged ones (no copy)."""
    return MergedParams(_map_params(lambda l, ax: l.narrow(ax, start, n), _as_tree(params)))


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
# lane / slot surgery on grid trees (caches and recurrent states)
# ---------------------------------------------------------------------------
#
# Serving keeps one cache/state tree for the whole (M, B) slot grid.  A
# logical-axes tree of the same structure (``dense.cache_axes``,
# ``ssm.state_axes``) names where the instances, batch and context dims
# sit on every leaf, so one set of helpers covers the dense KV-cache
# stacks (L, M, B, S, KVH, hd) and the nested recurrent states
# (sLSTM (M, B, D), mLSTM (L, M, B, ...), ``None`` for an empty run).


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in _leaves(v)]
    return [l for v in tree for l in _leaves(v)]


def tree_map(fn, *trees):
    """Map over matching tensors of dicts / lists / NamedTuples / tuples;
    ``None`` subtrees stay ``None``."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    vals = [tree_map(fn, *xs) for xs in zip(*trees)]
    return type(t0)(*vals) if hasattr(t0, "_fields") else type(t0)(vals)


def _is_axes(x) -> bool:
    # an axes leaf is a plain tuple of names; a NamedTuple (KVCache) is a
    # node whose fields are axes leaves
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def tree_map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over the leaves of ``trees``, each with its
    logical axes from ``axes_tree``."""
    if axes_tree is None:
        return None
    if _is_axes(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: tree_map_axes(fn, axes_tree[k], *(t[k] for t in trees))
                for k in axes_tree}
    vals = [tree_map_axes(fn, a, *xs) for a, xs in zip(axes_tree, zip(*trees))]
    t0 = trees[0]
    return type(t0)(*vals) if hasattr(t0, "_fields") else type(t0)(vals)


def _select(mask: torch.Tensor, new_tree, old_tree, axes_tree):
    """``torch.where`` of two grid trees with ``mask`` over each leaf's
    leading grid dims (instances, or instances and batch)."""
    def _sel(ax, n, o):
        i = ax.index("instances")
        if mask.ndim == 2:
            assert ax[i + 1] == "batch", ax
        mk = mask.reshape((1,) * i + tuple(mask.shape) + (1,) * (n.ndim - i - mask.ndim))
        return torch.where(mk, n, o)
    return tree_map_axes(_sel, axes_tree, new_tree, old_tree)


def tree_select_lanes(mask: torch.Tensor, new_tree, old_tree, axes_tree):
    """Lane k (along each leaf's instances axis) takes ``new_tree`` where
    ``mask[k]``, else keeps ``old_tree``."""
    return _select(mask, new_tree, old_tree, axes_tree)


def tree_select_slots(mask: torch.Tensor, new_tree, old_tree, axes_tree):
    """Slot (m, b) takes ``new_tree`` where ``mask[m, b]``, else keeps
    ``old_tree``."""
    return _select(mask, new_tree, old_tree, axes_tree)


def tree_reset_lanes(tree, init_lane, axes_tree, lanes: list[int]) -> None:
    """Copy the one-lane tree ``init_lane`` into rows ``lanes`` (along
    each leaf's instances axis) of ``tree``, in place: the in-place form
    of ``tree_select_lanes(fresh, init, carry)``."""
    def _reset(ax, leaf, init):
        i = ax.index("instances")
        for k in lanes:
            leaf.select(i, k).copy_(init.select(i, 0))
    if lanes:
        tree_map_axes(_reset, axes_tree, tree, init_lane)


def _slot(ax: tuple, leaf: torch.Tensor, m: int, b: int) -> torch.Tensor:
    i, j = ax.index("instances"), ax.index("batch")
    return leaf.narrow(i, m, 1).narrow(j, b, 1)


def tree_take_slot(tree, axes_tree, m: int, b: int):
    """Slot (m, b) of every grid leaf, singleton dims kept (a view)."""
    return tree_map_axes(lambda ax, l: _slot(ax, l, m, b), axes_tree, tree)


def tree_put_slot(grid, axes_tree, one, m: int, b: int):
    """Write a single-slot tree into grid slot (m, b), in place.  A leaf
    with a ``cache_seq`` axis longer or shorter than the grid's is
    prefix-clipped there, as in the reference; other leaves are copied
    whole.  Returns ``grid``."""
    def _put(ax, g, o):
        dst = _slot(ax, g, m, b)
        if "cache_seq" in ax:
            sa = ax.index("cache_seq")
            s = min(o.shape[sa], g.shape[sa])
            dst, o = dst.narrow(sa, 0, s), o.narrow(sa, 0, s)
        dst.copy_(o)
    tree_map_axes(_put, axes_tree, grid, one)
    return grid
