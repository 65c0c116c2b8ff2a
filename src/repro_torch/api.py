"""Uniform model API (port of ``repro.api``): the dense entries.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``); with no device given and no card present they raise
instead of carrying on on the CPU.  Families other than dense are not
ported yet and raise.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C
from repro_torch.models import dense


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the CUDA device; raises without a card
    unless the CPU was asked for explicitly."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was asked for but no CUDA device is present")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' (or --device cpu) "
            "to run on the CPU")
    return torch.device("cuda")


def family_module(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return dense


def init(cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
    """Random merged parameters (the reference's distributions) drawn from
    ``generator``, which must live on the target device."""
    dev = resolve_device(device)
    return family_module(cfg).init(cfg, generator, dev)


def prefill_prefix_len(cfg: ModelConfig) -> int:
    """Learned-prefix positions before the prompt (none for dense)."""
    family_module(cfg)
    return 0


def make_cache(cfg: ModelConfig, m: int, b: int, context_len: int, device=None):
    return family_module(cfg).make_cache(cfg, m, b, context_len, resolve_device(device))


def init_chunk_carry(cfg: ModelConfig, m: int, b: int, cache_len: int, device=None):
    return family_module(cfg).init_chunk_carry(cfg, m, b, cache_len,
                                               resolve_device(device))


def prefill_chunk(cfg: ModelConfig, params, batch, carry, offset, *, instances=None):
    return family_module(cfg).prefill_chunk(cfg, params, batch, carry, offset,
                                            instances=instances)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos, *, alive=None):
    return family_module(cfg).decode_step(cfg, params, cache, tokens, pos, alive=alive)


def decode_step_sample(cfg: ModelConfig, params, cache, tokens, pos, *, alive=None):
    """Greedy decode step: (next token (M, B) int32, cache)."""
    return family_module(cfg).decode_step_sample(cfg, params, cache, tokens, pos,
                                                 alive=alive)


def take_state(cfg: ModelConfig, cache, m: int, b: int):
    """Slot (m, b) of a grid cache (a view, singleton dims kept)."""
    family_module(cfg)
    return C.tree_take_slot(cache, m, b)


def put_state(cfg: ModelConfig, grid, one, m: int, b: int):
    """Write a single-slot cache into grid slot (m, b), in place."""
    family_module(cfg)
    return C.tree_put_slot(grid, one, m, b)
