"""Optimizers (port of ``repro.optim.adamw``): AdamW and SGD with
momentum, with global-norm gradient clipping.

Parameters, gradients and moments are trees of tensors (dicts and
lists, ``None`` for an empty node), or a ``MergedParams`` for the
parameters; the moments mirror the parameter tree in float32 on the
parameters' device.  An update runs under ``torch.no_grad()``: float32
math, the result written back into each parameter in its own dtype.

The clip norm is global over every leaf, so over all M merged instances
at once (the reference's coupling, ``examples/train_merged.py``): while
clipping is active, one instance's large gradient scales down the
others' steps.  The port keeps that coupling.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.common import MergedParams, _leaves, tree_map

Tree = Any

# elements of a leaf an AdamW update takes at once: its f32 temporaries
# are then a few pieces of 256 MB, not a few copies of the largest leaf
# (olmoe-1b-7b's (4, 2, 64, 2048, 1024) expert leaf is 4.3 GB in f32)
UPDATE_PIECE = 1 << 26


class OptState(NamedTuple):
    step: int
    mu: Tree           # first moment (or momentum for SGD)
    nu: Tree | None    # second moment (None for SGD)


def _tree(params) -> Tree:
    return params.tree() if isinstance(params, MergedParams) else params


def _zeros_like_f32(params) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    _tree(params))


def adamw_init(params) -> OptState:
    return OptState(0, _zeros_like_f32(params), _zeros_like_f32(params))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares (0-d f32)."""
    with torch.no_grad():
        sq = [g.float().square().sum() for g in _leaves(grads)]
        return torch.sqrt(torch.stack(sq).sum())


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(f32 copies of the gradients scaled to a global norm of at most
    ``max_norm``, the norm before clipping)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    with torch.no_grad():
        return tree_map(lambda g: g.float() * scale, grads), gn


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def adamw_update(grads, state: OptState, params, *, lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1, max_grad_norm: float = 1.0):
    """One AdamW step with the reference's bias correction.  The moments
    and the parameters are updated in place; returns (params, the new
    state, {"grad_norm": the norm before clipping}).  Gradients are
    clipped a leaf at a time, so no second copy of them is held, and a
    contiguous leaf is updated in flat pieces of ``UPDATE_PIECE``
    elements (element-wise math: the same numbers)."""
    gn = global_norm(grads)
    step = state.step + 1
    with torch.no_grad():
        scale = _clip_scale(gn, max_grad_norm).to(gn.device)
        # the bias corrections in f32, as the reference computes them
        c1 = float(1.0 - _f32(b1) ** _f32(step))
        c2 = float(1.0 - _f32(b2) ** _f32(step))
        lr = float(lr)

        def piece(p, g, m, v):
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            pf = p.float()
            delta = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * pf
            p.copy_((pf - lr * delta).to(p.dtype))

        def upd(*leaves):
            if not all(t.is_contiguous() for t in leaves):
                return piece(*leaves)
            for part in zip(*(t.view(-1).split(UPDATE_PIECE) for t in leaves)):
                piece(*part)

        tree_map(upd, _tree(params), grads, state.mu, state.nu)
    return params, OptState(step, state.mu, state.nu), {"grad_norm": gn}


def sgdm_init(params) -> OptState:
    return OptState(0, _zeros_like_f32(params), None)


def sgdm_update(grads, state: OptState, params, *, lr, momentum: float = 0.9,
                max_grad_norm: float = 1.0):
    """One SGD-with-momentum step, in place like :func:`adamw_update`."""
    gn = global_norm(grads)
    with torch.no_grad():
        scale = _clip_scale(gn, max_grad_norm).to(gn.device)
        lr = float(lr)

        def upd(p, g, m):
            m.mul_(momentum).add_(g.float() * scale)
            p.copy_((p.float() - lr * m).to(p.dtype))

        tree_map(upd, _tree(params), grads, state.mu)
    return params, OptState(state.step + 1, state.mu, None), {"grad_norm": gn}
