"""Chunked-prefill GQA attention over [cache before the chunk, chunk]:
the plain PyTorch version and the launcher of its Hopper kernel
(``csrc/chunk_prefill_attn.cu``).

Port of ``repro/kernels/chunk_prefill_attn.py`` (the Pallas ``_kernel``)
with the oracle of ``repro/kernels/ref.py`` (``chunk_prefill_attention``)
beside it: masking from the lane offsets alone (pinned-prefix ring,
causality, sliding window, attention sink), f32 throughout.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.models import layers as L

NEG_INF = -1e30


def _check(q, k, s_cache):
    m, b, c, h, hd = q.shape
    t, kvh = k.shape[2], k.shape[3]
    if t != s_cache + c:
        raise ValueError(f"k has {t} rows, expected s_cache + C = {s_cache + c}")
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")


def chunk_prefill_attention_plain(q, k, v, offset, *, s_cache: int, pin: int = 0,
                                  window: int = 0, sink: int = 0,
                                  causal: bool = True):
    """q (M, B, C, H, hd); k, v (M, B, s_cache + C, KVH, hd); offset
    (M, B) absolute position of each lane's first chunk token.  Returns
    (M, B, C, H, hd) in q's dtype; softmax and accumulation in f32."""
    _check(q, k, s_cache)
    m, b, c, h, hd = q.shape
    kvh = k.shape[3]
    g = h // kvh
    positions = offset[..., None] + torch.arange(c, dtype=offset.dtype,
                                                 device=offset.device)
    before = L.cache_positions_after(offset - 1, s_cache, pin)
    kv_pos = torch.cat([before, positions], dim=-1)                  # (M,B,T)
    qg = q.reshape(m, b, c, kvh, g, hd).float()
    scores = torch.einsum("mbckgd,mbskd->mbkgcs", qg, k.float()) / math.sqrt(hd)
    kp = kv_pos[:, :, None, :]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= positions[..., None])
    if window > 0:
        in_win = positions[..., None] - kp < window
        if sink > 0:
            in_win = in_win | (kp < sink)
        valid = valid & in_win
    scores = torch.where(valid[:, :, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("mbkgcs,mbskd->mbckgd", p, v.float())
    return o.reshape(m, b, c, h, hd).to(q.dtype)


def chunk_prefill_attention_cuda(q, k, v, offset, *, s_cache: int, pin: int = 0,
                                 window: int = 0, sink: int = 0, causal: bool = True):
    """The Hopper kernel: same contract as the plain version."""
    _check(q, k, s_cache)
    m, b, c, h, hd = q.shape
    kvh = k.shape[3]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or not t.is_contiguous() or t.dtype != q.dtype:
            raise ValueError(f"{name} must be a contiguous CUDA tensor of {q.dtype}")
    if hd > 128 or hd % 8:
        raise ValueError(f"the kernel takes head_dim <= 128 in multiples of 8, not {hd}")
    off = offset.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = build.entry("chunk_prefill_attn", "chunk_prefill_attention",
                     "ipppppiiiiiiiiiifp")
    P = build.ptr
    build.check(fn(build.dtype_code(q), P(q), P(k), P(v), P(off), P(out), m * b, c, h,
                   kvh, hd, s_cache, pin, window, sink, int(causal),
                   math.sqrt(hd), build.stream_ptr(q)), "chunk_prefill_attention")
    return out
