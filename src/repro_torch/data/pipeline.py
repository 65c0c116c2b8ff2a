"""Data pipeline: synthetic and file-backed token streams (port of
``repro.data.pipeline``).

* :class:`SyntheticLM` -- deterministic Zipf-ish synthetic tokens; each
  merged instance gets its own stream (different inputs per merged
  model, the paper's setting).
* :class:`MemmapLM` -- file-backed token shards (uint32 memmap) with
  sequence packing and epoch shuffling; :func:`write_token_file` writes
  shards.

Every batch is drawn with the reference's numpy ``default_rng`` calls in
the reference's order, so it is the reference's batch bit for bit.
Batches follow the layout of ``repro_torch.api``: tokens (M, B, S) int32
and labels = the next tokens, as torch tensors on ``device`` (the CPU
unless the caller names another).  The vlm and audio frontends are
stubs that draw deterministic pseudo-embeddings, as in the reference.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _tokens(toks: np.ndarray, device) -> dict:
    return {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :, :-1])).to(device),
            "labels": torch.from_numpy(np.ascontiguousarray(toks[:, :, 1:])).to(device)}


@dataclasses.dataclass
class SyntheticLM:
    """Deterministic synthetic LM stream; instance m draws from a shifted
    Zipf distribution so merged instances see genuinely different inputs."""
    vocab_size: int
    num_instances: int = 1
    seed: int = 0
    device: str | torch.device = "cpu"

    def batch(self, step: int, batch_size: int, seq_len: int) -> dict:
        m = self.num_instances
        toks = np.empty((m, batch_size, seq_len + 1), np.int32)
        for i in range(m):
            g = _rng(self.seed * 1_000_003 + step * 131 + i)
            # Zipf-flavored: mix of low-id-heavy and uniform tokens
            z = g.zipf(1.3, size=(batch_size, seq_len + 1))
            u = g.integers(0, self.vocab_size, size=(batch_size, seq_len + 1))
            pick = g.random((batch_size, seq_len + 1)) < 0.5
            toks[i] = np.where(pick, np.minimum(z, self.vocab_size - 1), u)
        return _tokens(toks, self.device)


def write_token_file(path: str | Path, tokens: np.ndarray) -> None:
    """Write a uint32 token shard."""
    np.asarray(tokens, np.uint32).tofile(str(path))


@dataclasses.dataclass
class MemmapLM:
    """File-backed packed-token stream.  Documents are already
    concatenated in the shard; (seq_len + 1)-token windows are sliced
    with a per-instance deterministic shuffle of window offsets."""
    paths: list[str]
    num_instances: int = 1
    seed: int = 0
    device: str | torch.device = "cpu"

    def __post_init__(self):
        self._shards = [np.memmap(p, dtype=np.uint32, mode="r") for p in self.paths]
        self._sizes = [len(s) for s in self._shards]

    def batch(self, step: int, batch_size: int, seq_len: int) -> dict:
        m = self.num_instances
        need = seq_len + 1
        toks = np.empty((m, batch_size, need), np.int32)
        for i in range(m):
            shard = self._shards[(step + i) % len(self._shards)]
            n_windows = max(1, (len(shard) - need) // need)
            g = _rng(self.seed * 7_919 + i)
            perm = g.permutation(n_windows)
            for b in range(batch_size):
                w = perm[(step * batch_size + b) % n_windows]
                toks[i, b] = shard[w * need: w * need + need].astype(np.int32)
        return _tokens(toks, self.device)


# ---------------------------------------------------------------------------
# modality frontend stubs (precomputed embeddings)
# ---------------------------------------------------------------------------


def make_vlm_batch(cfg, step: int, batch_size: int, seq_len: int, seed: int = 0,
                   device="cpu") -> dict:
    """tokens + stub ViT patch embeddings; seq_len counts total positions."""
    m, p = cfg.num_instances, cfg.num_image_patches
    b = SyntheticLM(cfg.vocab_size, m, seed, device).batch(step, batch_size, seq_len - p)
    g = _rng(seed * 97 + step)
    img = g.standard_normal((m, batch_size, p, cfg.vision_embed_dim), np.float32) * 0.5
    b["image_embeds"] = torch.from_numpy(img).to(device=device, dtype=getattr(torch, cfg.dtype))
    return b


def make_audio_batch(cfg, step: int, batch_size: int, seq_len: int, seed: int = 0,
                     device="cpu") -> dict:
    """decoder tokens + stub post-conv frame embeddings."""
    m = cfg.num_instances
    b = SyntheticLM(cfg.vocab_size, m, seed, device).batch(step, batch_size, seq_len)
    g = _rng(seed * 89 + step)
    fr = g.standard_normal((m, batch_size, cfg.num_audio_frames, cfg.d_model), np.float32) * 0.5
    b["frames"] = torch.from_numpy(fr).to(device=device, dtype=getattr(torch, cfg.dtype))
    return b


def make_batch(cfg, step: int, batch_size: int, seq_len: int, seed: int = 0,
               device="cpu") -> dict:
    if cfg.family == "vlm":
        return make_vlm_batch(cfg, step, batch_size, seq_len, seed, device)
    if cfg.family == "audio":
        return make_audio_batch(cfg, step, batch_size, seq_len, seed, device)
    return SyntheticLM(cfg.vocab_size, cfg.num_instances, seed, device).batch(
        step, batch_size, seq_len)
