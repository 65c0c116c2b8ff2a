"""Carry a parameter tree of the JAX package across to the port.

The tree is the reference's nested structure with numpy leaves (what
``numpy.asarray`` makes of ``repro.api.init``'s output, or of
``repro.models.{cnn,encoder}.init`` for the paper's models): dicts, and
lists (the ssm family's runs, with ``None`` for an empty mLSTM run; the
CNN's stages of blocks).  This module
never imports JAX.  Layouts are kept as they are: leading M axis, layers
stacked on L, (M, D, F) weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs.base import ModelConfig
from repro_torch.models import cnn, encoder
from repro_torch.models.common import MergedParams

# the paper's models are called through their modules, not through ``api``
_PAPER_FAMILY = {"cnn": cnn, "encoder": encoder}


def params_from_numpy(cfg: ModelConfig, tree: dict, device) -> MergedParams:
    """The port's merged model from a reference parameter tree, in the
    family's storage dtypes and layouts (``storage_dtypes`` of the family
    module)."""
    fam = _PAPER_FAMILY.get(cfg.family) or api.family_module(cfg)

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    return MergedParams(fam.storage_dtypes(cfg, conv(tree)))
