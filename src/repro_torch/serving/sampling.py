"""On-device sampling over the whole (M, B) serving grid (port of
``repro.serving.sampling``).

Greedy (temperature <= 0) is the first-occurrence argmax of the f32
logits, as in the reference.  Temperature and top-k draw from an
explicit ``torch.Generator``; torch's generator is not JAX's, so those
streams match the reference in distribution only.  A row whose logits
are not all finite draws from a uniform stand-in instead (``multinomial``
refuses NaN probabilities): the engine's NaN/Inf guard fails that row's
request, and the other rows draw exactly as they would have.  The
sampler returns that finiteness with the tokens, so the engine reads the
logits for its guard only once.
"""
from __future__ import annotations

import functools

import torch

NEG_INF = -1e30


def sample_tokens(logits: torch.Tensor, generator: torch.Generator | None = None, *,
                  temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits (M, B, V) -> ((M, B) int32 tokens, (M, B) bool: the row's
    logits, over the temperature, are all finite)."""
    if temperature <= 0:
        return logits.argmax(dim=-1).to(torch.int32), torch.isfinite(logits).all(-1)
    m, b, v = logits.shape
    scaled = logits.float() / temperature
    finite = torch.isfinite(scaled).all(-1, keepdim=True)
    scaled = torch.where(finite, scaled, torch.zeros_like(scaled))
    if 0 < top_k < v:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, torch.full_like(scaled, NEG_INF), scaled)
    probs = torch.softmax(scaled.reshape(m * b, v), dim=-1)
    flat = torch.multinomial(probs, 1, generator=generator)
    return flat.reshape(m, b).to(torch.int32), finite.reshape(m, b)


def make_grid_sampler(temperature: float, top_k: int = 0):
    return functools.partial(sample_tokens, temperature=temperature, top_k=top_k)
