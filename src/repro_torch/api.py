"""Uniform model API (port of ``repro.api``): the dense, moe, ssm,
hybrid, vlm and audio entries.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``); with no device given and no card present they raise
instead of carrying on on the CPU.  The training and whole-sequence
entries (``train_logits``, ``loss_fn``, ``prefill``, ``init(...,
train=True)``) take all six families, with the reference's batch layout:
tokens and labels (M, B, S) int32; vlm adds ``image_embeds`` (M, B, P,
vision_dim) (S counts the text), audio ``frames`` (M, B, F, D).

``tp`` (a ``models.common.TensorParallel``) runs an entry on this rank's
shard under tensor parallelism; the dense, moe, ssm, hybrid and vlm
families take it (audio raises: its model axis is ROADMAP Queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C
from repro_torch.models import audio, dense, hybrid, moe, ssm, vlm
from repro_torch.models import shardings as S

_FAMILY = {"dense": dense, "moe": moe, "ssm": ssm, "hybrid": hybrid, "vlm": vlm,
           "audio": audio}


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


def settle(device: torch.device) -> None:
    """Wait until the work queued on ``device`` has run (a no-op on the
    CPU): where the reference calls ``jax.block_until_ready``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def family_module(cfg: ModelConfig):
    if cfg.family not in _FAMILY:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return _FAMILY[cfg.family]


def _tp(cfg: ModelConfig, tp) -> dict:
    """The ``tp`` keyword for the family's entry, where there is a handle."""
    if tp is None:
        return {}
    S.refuse_family(cfg)
    return {"tp": tp}


def init(cfg: ModelConfig, generator: torch.Generator | None = None, device=None, *,
         train: bool = False):
    """Random merged parameters (the reference's distributions) drawn from
    ``generator``, which must live on the target device.  ``train`` gives
    the trainable form (every leaf in ``param_dtype``, requiring a
    gradient)."""
    dev = resolve_device(device)
    if train:
        return _whole_sequence(cfg).init(cfg, generator, dev, train=True)
    return family_module(cfg).init(cfg, generator, dev)


# ---------------------------------------------------------------------------
# whole-sequence entry points: training and a prefill from scratch
# ---------------------------------------------------------------------------

# families whose whole-sequence forward and prefill are ported
WHOLE_SEQUENCE = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _whole_sequence(cfg: ModelConfig):
    if cfg.family not in WHOLE_SEQUENCE:
        raise NotImplementedError(
            f"the whole-sequence forward of the {cfg.family!r} family is not ported")
    return _FAMILY[cfg.family]


def train_logits(cfg: ModelConfig, params, batch, *, remat: bool | None = None):
    """Logits (M, B, S, V) f32 aligned with ``batch["labels"]`` (the next
    tokens; vlm's text positions); for moe (logits, the router's aux
    loss), as the reference returns them.  ``remat`` defaults to
    ``cfg.remat``."""
    remat = cfg.remat if remat is None else remat
    fam, tok = _whole_sequence(cfg), batch["tokens"]
    if cfg.family == "moe":
        return fam.forward(cfg, params, tok, remat=remat, return_aux=True)
    if cfg.family == "vlm":
        return fam.text_logits(cfg, params, tok, batch["image_embeds"], remat=remat)
    if cfg.family == "audio":
        return fam.forward(cfg, params, tok, batch["frames"], remat=remat)
    return fam.forward(cfg, params, tok, remat=remat)


def loss_fn(cfg: ModelConfig, params, batch):
    """Mean next-token cross-entropy over (M, B, S) from the f32
    log-softmax, plus ``cfg.router_aux_loss`` times moe's aux (0 for the
    other families): (loss, {"nll", "aux"})."""
    out = train_logits(cfg, params, batch)
    logits, aux = out if cfg.family == "moe" else (out, None)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
    loss = nll.mean()
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss + cfg.router_aux_loss * aux, {"nll": loss, "aux": aux}


def prefill(cfg: ModelConfig, params, batch, *, cache_len: int | None = None):
    """A whole prompt from scratch, without a gradient: (last logits
    (M, B, V) f32, the decode cache or recurrent state).  ``cache_len``
    sizes the KV cache (dense, moe, vlm) or the audio self ring; the ssm
    state is positionless and the hybrid cache is sized by its window.
    vlm reads ``batch["image_embeds"]``, audio ``batch["frames"]``."""
    fam, tok = _whole_sequence(cfg), batch["tokens"]
    with torch.no_grad():
        if cfg.family in ("dense", "moe"):
            return fam.prefill(cfg, params, tok, cache_len=cache_len)
        if cfg.family == "vlm":
            return fam.prefill(cfg, params, tok, batch["image_embeds"], cache_len=cache_len)
        if cfg.family == "audio":
            return fam.prefill(cfg, params, tok, batch["frames"], cache_len=cache_len)
        return fam.prefill(cfg, params, tok)


def prefill_prefix_len(cfg: ModelConfig) -> int:
    """Learned-prefix positions before the prompt: hybrid's meta tokens,
    vlm's image patches, none for dense, moe, ssm and audio (whose prefix,
    the audio frames, reaches the decoder through the cross-attention)."""
    family_module(cfg)
    if cfg.family == "hybrid":
        return hybrid.NUM_META_TOKENS
    return cfg.num_image_patches if cfg.family == "vlm" else 0


def make_cache(cfg: ModelConfig, m: int, b: int, context_len: int, device=None, tp=None):
    """The grid's decode cache: a KV cache (dense, moe, vlm), the recurrent state
    (ssm, positionless: ``context_len`` is unused), per-group KV caches
    and mamba states (hybrid) or a KV cache and the cross-attention K/V
    (audio)."""
    dev = resolve_device(device)
    kw = _tp(cfg, tp)
    if cfg.family == "ssm":
        return ssm.make_state(cfg, m, b, dev, **kw)
    return family_module(cfg).make_cache(cfg, m, b, context_len, dev, **kw)


def cache_axes(cfg: ModelConfig):
    """Logical-axes tree matching :func:`make_cache`'s structure."""
    if cfg.family == "ssm":
        return ssm.state_axes(cfg)
    return family_module(cfg).cache_axes(cfg)


def init_chunk_carry(cfg: ModelConfig, m: int, b: int, cache_len: int, device=None,
                     tp=None):
    return family_module(cfg).init_chunk_carry(cfg, m, b, cache_len,
                                               resolve_device(device), **_tp(cfg, tp))


def chunk_carry_axes(cfg: ModelConfig):
    """Logical-axes tree matching :func:`init_chunk_carry`'s structure."""
    return family_module(cfg).chunk_carry_axes(cfg)


def prefill_chunk(cfg: ModelConfig, params, batch, carry, offset, *, instances=None,
                  tp=None):
    return family_module(cfg).prefill_chunk(cfg, params, batch, carry, offset,
                                            instances=instances, **_tp(cfg, tp))


def decode_step(cfg: ModelConfig, params, cache, tokens, pos, *, alive=None, tp=None):
    return family_module(cfg).decode_step(cfg, params, cache, tokens, pos, alive=alive,
                                          **_tp(cfg, tp))


def decode_step_sample(cfg: ModelConfig, params, cache, tokens, pos, *, alive=None,
                       tp=None):
    """Greedy decode step: (next token (M, B) int32, cache)."""
    return family_module(cfg).decode_step_sample(cfg, params, cache, tokens, pos,
                                                 alive=alive, **_tp(cfg, tp))


def take_state(cfg: ModelConfig, cache, m: int, b: int):
    """Slot (m, b) of a grid cache or state (views, singleton dims kept):
    the family's own helper where it has one (ssm), else the axes-driven
    surgery over :func:`cache_axes`."""
    fam = family_module(cfg)
    if hasattr(fam, "take_state"):
        return fam.take_state(cfg, cache, m, b)
    return C.tree_take_slot(cache, cache_axes(cfg), m, b)


def put_state(cfg: ModelConfig, grid, one, m: int, b: int):
    """Write a single-slot cache or state into grid slot (m, b), in place;
    a context axis is prefix-clipped.  Inverse of :func:`take_state`."""
    fam = family_module(cfg)
    if hasattr(fam, "put_state"):
        return fam.put_state(cfg, grid, one, m, b)
    return C.tree_put_slot(grid, cache_axes(cfg), one, m, b)
