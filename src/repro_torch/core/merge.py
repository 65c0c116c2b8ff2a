"""Parameter-tree merging — the NetFuse path (port of ``repro.core.merge``).

Merging M fine-tuned instances of one architecture is stacking their
parameter trees along a new leading ``instances`` axis; the model zoo is
written fusion-aware, so M=1 is the plain model.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.models.common import MergedParams, _leaves, tree_map

Tree = Any


def _plain(tree):
    return tree.tree() if isinstance(tree, MergedParams) else tree


def _structure(tree):
    if isinstance(tree, dict):
        return tuple((k, _structure(v)) for k, v in sorted(tree.items()))
    if isinstance(tree, (list, tuple)):
        return ("list",) + tuple(_structure(v) for v in tree)
    return None if tree is None else tuple(tree.shape)


def stack_instances(params_list: Sequence[Tree]) -> Tree:
    """Stack M per-instance trees along a new leading axis.  All trees
    must share structure and leaf shapes (the NetFuse precondition)."""
    trees = [_plain(p) for p in params_list]
    if len({_structure(t) for t in trees}) != 1:
        raise ValueError(
            "cannot merge models with different architectures "
            f"(got {len({_structure(t) for t in trees})} distinct param structures)"
        )
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def unstack_instances(merged: Tree) -> list[Tree]:
    """Inverse of :func:`stack_instances` (views, no copy)."""
    merged = _plain(merged)
    return [tree_map(lambda x, i=i: x[i], merged)
            for i in range(num_instances(merged))]


def concat_instances(merged_a: Tree, merged_b: Tree) -> Tree:
    """Merge two already-merged models (M_a + M_b instances): grouped ops
    compose (paper section 3.1)."""
    return tree_map(lambda a, b: torch.cat([a, b]), _plain(merged_a), _plain(merged_b))


def add_instance_axis(params: Tree) -> Tree:
    """Lift a plain (unmerged) tree to the M=1 instance-axis form (views)."""
    return tree_map(lambda x: x[None], _plain(params))


def num_instances(merged: Tree) -> int:
    return _leaves(_plain(merged))[0].shape[0]
