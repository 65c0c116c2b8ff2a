"""On-device sampling over the whole (M, B) serving grid (port of
``repro.serving.sampling``).

Greedy (temperature <= 0) is the first-occurrence argmax of the f32
logits, as in the reference.  Temperature and top-k draw from an
explicit ``torch.Generator``; torch's generator is not JAX's, so those
streams match the reference in distribution only.
"""
from __future__ import annotations

import functools

import torch

NEG_INF = -1e30


def sample_tokens(logits: torch.Tensor, generator: torch.Generator | None = None, *,
                  temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits (M, B, V) -> (M, B) int32."""
    if temperature <= 0:
        return logits.argmax(dim=-1).to(torch.int32)
    m, b, v = logits.shape
    scaled = logits.float() / temperature
    if 0 < top_k < v:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, torch.full_like(scaled, NEG_INF), scaled)
    probs = torch.softmax(scaled.reshape(m * b, v), dim=-1)
    flat = torch.multinomial(probs, 1, generator=generator)
    return flat.reshape(m, b).to(torch.int32)


def make_grid_sampler(temperature: float, top_k: int = 0):
    return functools.partial(sample_tokens, temperature=temperature, top_k=top_k)
