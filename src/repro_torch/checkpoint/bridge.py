"""Carry a parameter tree of the JAX package across to the port.

The tree is the reference's nested dict with numpy leaves (what
``numpy.asarray`` makes of ``repro.api.init``'s output) -- this module
never imports JAX.  Layouts are kept as they are: leading M axis, layers
stacked on L, (M, D, F) weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense
from repro_torch.models.common import MergedParams


def params_from_numpy(cfg: ModelConfig, tree: dict, device) -> MergedParams:
    """The port's merged model from a reference parameter tree, in the
    port's storage dtypes (layer matmul weights in ``cfg.dtype``; embed,
    lm_head and norm scales in ``cfg.param_dtype``)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    return MergedParams(dense.storage_dtypes(cfg, conv(tree)))
