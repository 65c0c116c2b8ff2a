"""Fusion-aware neural-net primitives (port of ``repro.models.layers``).

Activations are ``(M, B, ...)``, weights carry a leading ``M``.  Every op
rounds where the reference rounds: weights cast to the activation dtype
in ``linear``, f32 norm statistics, f32 logits.

``groups=`` (a :class:`LaneGroups`) runs rows of the activations against
chosen instances of the merged weights: the serving prefill batches lanes
of different fine-tunes this way, through views of the weights instead
of a gathered copy of the whole model per call.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import fused_ops


class LaneGroups:
    """Row i of the activations reads instance ``instances[i]`` of the
    merged weights (rows may share an instance).

    A matrix product stays one batched matmul over the M_w instances:
    rows are scattered into an (M_w, R, ...) block -- R the most rows any
    instance has, missing rows zero -- multiplied, and gathered back.
    When row i reads instance i the block is the activations themselves.
    Small per-row leaves (norm scales, biases) are gathered by ``rows``."""

    def __init__(self, instances: list[int], m_w: int, device):
        rank, seen = [], {}
        for t in instances:
            rank.append(seen.get(t, 0))
            seen[t] = rank[-1] + 1
        self.m_w = m_w
        self.reps = max(seen.values())
        self.identity = list(instances) == list(range(m_w))
        self.t = torch.tensor(instances, dtype=torch.long, device=device)
        self.r = torch.tensor(rank, dtype=torch.long, device=device)

    def rows(self, leaf: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Per-row copies of a leaf's instance rows along ``dim``."""
        return leaf if self.identity else leaf.index_select(dim, self.t)

    def matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (k, ..., D) @ w (M_w, D, F) with row i on instance t[i]."""
        k, d = x.shape[0], x.shape[-1]
        xf = x.reshape(k, -1, d)
        if self.identity:
            y = torch.matmul(xf, w.to(x.dtype))
        else:
            n = xf.shape[1]
            xm = xf.new_zeros(self.m_w, self.reps, n, d)
            xm[self.t, self.r] = xf
            y = torch.matmul(xm.view(self.m_w, self.reps * n, d), w.to(x.dtype))
            y = y.view(self.m_w, self.reps, n, -1)[self.t, self.r]
        return y.reshape(*x.shape[:-1], w.shape[-1])


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           groups: LaneGroups | None = None) -> torch.Tensor:
    """Merged matmul: x (M, ..., D) @ w (M, D, F) [+ b (M, F)].  With
    ``groups``, w is (M_w, D, F) and b is already per row (M, F)."""
    m, d = x.shape[0], x.shape[-1]
    if groups is None:
        y = torch.matmul(x.reshape(m, -1, d), w.to(x.dtype))
        y = y.reshape(*x.shape[:-1], w.shape[-1])
    else:
        y = groups.matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype).reshape(m, *([1] * (y.ndim - 2)), b.shape[-1])
    return y


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x (M, ..., D), scale (M, D).  Stats in f32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    m, d = scale.shape
    s = scale.float().reshape((m,) + (1,) * (x.ndim - 2) + (d,))
    return (y * s).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None,
               eps: float = 1e-5) -> torch.Tensor:
    """Merged layer norm (group norm with G=M, instance-axis form): stats
    in f32 (population variance), the result in x's dtype."""
    y = fused_ops.merged_layer_norm(x.float(), scale.float(),
                                    None if bias is None else bias.float(), eps=eps)
    return y.to(x.dtype)


def embed(ids: torch.Tensor, table: torch.Tensor, dtype: torch.dtype,
          instances: list[int] | None = None) -> torch.Tensor:
    """ids (M, B, S), table (M_t, V, D) -> (M, B, S, D) in ``dtype``."""
    return fused_ops.merged_embedding(ids, table, instances).to(dtype)


def unembed(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Logits in f32: x (M, B, S, D), head (M, D, V) -> (M, B, S, V)."""
    m, d = x.shape[0], x.shape[-1]
    y = torch.matmul(x.float().reshape(m, -1, d), head.float())
    return y.reshape(*x.shape[:-1], head.shape[-1])


def swiglu_mlp(x, wg, wu, wd, groups: LaneGroups | None = None):
    h = F.silu(linear(x, wg, groups=groups)) * linear(x, wu, groups=groups)
    return linear(h, wd, groups=groups)


def gelu_mlp(x, w1, b1, w2, b2):
    """The encoder's MLP; ``jax.nn.gelu``'s default is the tanh form."""
    return linear(F.gelu(linear(x, w1, b1), approximate="tanh"), w2, b2)


def rope_tables(pos: torch.Tensor, hd: int, theta: float, dtype: torch.dtype):
    """cos, sin (M, B, S, 1, hd/2) in ``dtype`` for positions (M, B, S):
    f32 angles, as the reference computes them."""
    half = hd // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(half, dtype=torch.float32, device=pos.device) / half)
    ang = pos.float()[..., None] * freqs                       # (M,B,S,half)
    return (torch.cos(ang)[..., None, :].to(dtype),
            torch.sin(ang)[..., None, :].to(dtype))


def rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x (M, B, S, H, hd), pos (M, B, S) int."""
    return rope_apply(x, *rope_tables(pos, x.shape[-1], theta, x.dtype))


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

NEG_INF = -1e30


class KVCache(NamedTuple):
    """Ring-buffer KV cache for one layer stack.

    k, v: (L, M, B, S_cache, KVH, hd).  Slot positions are reconstructed
    arithmetically from the decode position; no position array is kept.
    The port updates caches in place (the reference's functional updates
    become writes into these tensors)."""
    k: torch.Tensor
    v: torch.Tensor


def make_kv_cache(num_layers: int, m: int, b: int, s_cache: int, kvh: int,
                  hd: int, dtype: torch.dtype, device) -> KVCache:
    shape = (num_layers, m, b, s_cache, kvh, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def cache_slot_positions(pos: torch.Tensor, s_cache: int) -> torch.Tensor:
    """Absolute position held by each ring slot after writing the token
    at ``pos`` into slot ``pos % s_cache``.  pos (M, B) -> (M, B, S),
    -1 where the slot is empty."""
    slots = torch.arange(s_cache, dtype=pos.dtype, device=pos.device)
    cur = pos[..., None] % s_cache
    base = pos[..., None] - cur
    p = torch.where(slots <= cur, base + slots, base - s_cache + slots)
    return torch.where(p >= 0, p, torch.full_like(p, -1))


def cache_positions_after(last_pos: torch.Tensor, s_cache: int,
                          pin: int = 0) -> torch.Tensor:
    """Slot -> absolute position after writing every position up to
    ``last_pos`` (inclusive; -1 = nothing written), for a cache whose
    first ``pin`` slots are pinned and whose other ``s_cache - pin`` slots
    ring over positions >= pin.  last_pos (M, B) -> (M, B, S), -1 marking
    empty slots.  torch's ``%`` floors like JAX's."""
    slots = torch.arange(s_cache, dtype=last_pos.dtype, device=last_pos.device)
    last = last_pos[..., None]
    w = s_cache - pin
    neg = torch.full_like(slots, -1)
    pinned = torch.where(slots <= last, slots, neg)
    if w <= 0:
        return pinned
    q = last - pin
    cur = q % w
    base = q - cur
    i = slots - pin
    p = torch.where(i <= cur, base + i, base - w + i) + pin
    ring = torch.where((q >= 0) & (p >= pin), p, neg)
    return torch.where(slots < pin, pinned, ring)


def chunk_slots(positions: torch.Tensor, s_cache: int, pin: int = 0) -> torch.Tensor:
    """Cache slot of each position: p when p < pin, else
    pin + (p - pin) % (s_cache - pin)."""
    w = max(s_cache - pin, 1)
    return torch.where(positions < pin, positions, pin + (positions - pin) % w)


def chunk_write_index(positions: torch.Tensor, s_cache: int, pin: int = 0,
                      valid: torch.Tensor | None = None):
    """(rows, slots, keep) addressing a chunk's cache writes: flat lane
    row, cache slot and validity of every (lane, position).  Every layer
    of one chunk call writes through the same index."""
    m, b, c = positions.shape
    slots = chunk_slots(positions, s_cache, pin).reshape(m * b, c).long()
    rows = torch.arange(m * b, device=positions.device)[:, None].expand(m * b, c)
    keep = None if valid is None else valid.reshape(m * b, c, 1, 1)
    return rows, slots, keep


def cache_append_chunk(cache_layer: torch.Tensor, new: torch.Tensor,
                       positions: torch.Tensor, pin: int = 0,
                       valid: torch.Tensor | None = None, index=None) -> torch.Tensor:
    """Write a chunk of k/v rows into their cache slots, in place.

    cache_layer: (M, B, S, KVH, hd); new: (M, B, C, KVH, hd); positions:
    (M, B, C).  ``index`` (from :func:`chunk_write_index`) may be given to
    share it across layers.  Positions of one chunk map to distinct slots
    (the serving runtime clamps the chunk to the ring width), so rows
    with ``valid`` False rewrite their slot's old value: the write is
    dropped without a host-side index compaction."""
    m, b, s, kvh, hd = cache_layer.shape
    c = new.shape[2]
    rows, sl, keep = (index if index is not None
                      else chunk_write_index(positions, s, pin, valid))
    flat = cache_layer.view(m * b, s, kvh, hd)
    vals = new.to(cache_layer.dtype).reshape(m * b, c, kvh, hd)
    if keep is not None:
        vals = torch.where(keep, vals, flat[rows, sl])
    flat[rows, sl] = vals
    return cache_layer


def cache_update_one(cache_layer: torch.Tensor, new: torch.Tensor, slot: torch.Tensor,
                     alive: torch.Tensor | None = None) -> torch.Tensor:
    """Write one token's k or v row per lane at ``slot``, in place.

    cache_layer: (M, B, S, KVH, hd); new: (M, B, 1, KVH, hd); slot: (M, B).
    A lane whose ``alive`` (M, B) is False keeps its slot's old value, so
    a stopped lane's cache stays frozen without a copy of the cache."""
    m, b, s, kvh, hd = cache_layer.shape
    flat = cache_layer.view(m * b, s, kvh, hd)
    rows = torch.arange(m * b, device=cache_layer.device)
    sl = slot.reshape(m * b).long()
    vals = new.to(cache_layer.dtype).reshape(m * b, kvh, hd)
    if alive is not None:
        vals = torch.where(alive.reshape(m * b, 1, 1), vals, flat[rows, sl])
    flat[rows, sl] = vals
    return cache_layer


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                          window: int = 0, sink: int = 0) -> torch.Tensor:
    """Causal GQA attention with the reference's positional mask
    (``flash_attention`` of ``repro/models/layers.py``) as one block:
    q (M, B, Sq, H, hd); k, v (M, B, Skv, KVH, hd); q_pos (M, B, Sq);
    kv_pos (M, B, Skv) with -1 marking empty slots.  A key is visible
    when kv_pos >= 0, kv_pos <= q_pos and, with a ``window``, q_pos -
    kv_pos < window or kv_pos < ``sink``.  f32 scores, p in V's dtype,
    f32 accumulation, as the reference's single-block decode path.
    Returns (M, B, Sq, H, hd) in q's dtype."""
    m, b, sq, h, hd = q.shape
    kvh = k.shape[3]
    g = h // kvh
    qg = q.reshape(m, b, sq, kvh, g, hd).float()
    s = torch.einsum("mbqkgd,mbckd->mbkgqc", qg, k.float()) * (1.0 / math.sqrt(hd))
    kp = kv_pos[:, :, None, :]
    qp = q_pos[..., None]
    valid = (kp >= 0) & (kp <= qp)
    if window > 0:
        in_win = qp - kp < window
        if sink > 0:
            in_win = in_win | (kp < sink)
        valid = valid & in_win
    s = torch.where(valid[:, :, None, None], s, torch.full_like(s, NEG_INF))
    mx = torch.clamp(s.amax(dim=-1), min=NEG_INF)
    p = torch.exp(s - mx[..., None])
    l = p.sum(dim=-1)
    pv = torch.einsum("mbkgqc,mbckd->mbkgqd", p.to(v.dtype).float(), v.float())
    o = pv / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 1, 4, 2, 3, 5).reshape(m, b, sq, h, hd).to(q.dtype)
