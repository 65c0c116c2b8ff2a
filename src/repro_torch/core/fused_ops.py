"""Fusion-aware ops in instance-axis form (port of
``repro.core.fused_ops``; this slice takes the embedding only)."""
from __future__ import annotations

import torch


def merged_embedding(ids: torch.Tensor, table: torch.Tensor,
                     instances: list[int] | None = None) -> torch.Tensor:
    """ids: (M, ...), table: (M_t, V, D) -> (M, ..., D).

    Each instance's ids index only that instance's table.  ``instances``
    maps row i of ``ids`` to table row ``instances[i]`` (per-lane views:
    no copy of the tables); by default row i reads table i."""
    rows = range(ids.shape[0]) if instances is None else instances
    return torch.stack([table[t][ids[i].long()] for i, t in enumerate(rows)])
