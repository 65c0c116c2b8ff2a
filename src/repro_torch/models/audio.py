"""Whisper-style encoder-decoder -- whisper-small (port of
``repro.models.audio``).

As in the reference, the mel spectrogram and the conv front end are a
stub: the caller hands in post-conv frame embeddings (M, B, F, D), and
serving feeds zero frames.  This module holds what follows them: the
sinusoidal encoder positions, the bidirectional encoder stack and the
causal decoder with self- and cross-attention (pre-LN with biases, GELU
MLPs with biases, bq / bv / bo but no bk, learned decoder positions).

Attention of the encoder (all F frames, no mask) and of a prefill
chunk's decoder self-attention (over [cache so far, chunk], causal) is
the chunk-attention kernel (``ops.chunk_prefill_attention``; the
encoder's call has no cache, ``causal=False``, one chunk of F rows at
offset 0).  A prefill chunk's cross-attention over the F frames, which the
reference computes outside any kernel, is two f32 products on the
merged-matmul kernel (one per lane and kv head, so a lane's result does
not depend on how many lanes share the chunk call) around a plain
softmax.  Decode runs both of its attentions through the decode-attention
kernel: the self-attention over the ring's first min(pos + 1, S) slots,
the cross-attention over all F cached frames.  Greedy decode ends in a
final layer norm, the tied head (``embed``ᵀ) in f32 and an argmax (first
occurrence on ties): the fused logits kernel does an RMS norm, and the
reference computes these outside any kernel too.

The prefill reruns the encoder on every chunk and rewrites the cross K/V
of each lane that advances, as the reference does (computing it once per
request is left for later).  The decode cache is
``{"self": KVCache, "cross_k", "cross_v"}``, each (L, M, B, ·, KVH, hd);
the cross leaves' F axis is labelled ``cache_seq`` like the self cache's,
and a slot copy moves all F rows (the grid's F equals the carry's).
Norms reduce each row on its own (``layers.layer_norm_rowwise``), so a
lane's decode does not depend on how many rows share the call.  Caches
are updated in place; ``alive`` (M, B) leaves a stopped lane's ring
untouched.  One device only: ``api`` raises under a mesh.

Training and a prefill from scratch (``forward``, ``decode_full``,
``prefill``) take the reference's XLA form: the encoder
(:func:`encode_seq`), the decoder's causal self-attention and its
cross-attention all run ``layers.flash_attention_plain`` (the encoder
and the cross-attention with ``causal=False``), so no kernel is reached
under a gradient.  The serving :func:`encode` and :func:`prefill_chunk`
keep the kernels.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.models import layers as L
from repro_torch.models.common import MergedParams, draw_leaf, training_params
from repro_torch.models.layers import KVCache
from repro_torch.models.ssm import _lane_rows

# layer leaves stored in cfg.dtype (``layers.linear`` casts them to the
# activation dtype at every call, so casting once at load computes the
# same numbers); embed, pos_embed and the norm scales and biases stay in
# param_dtype
_ATTN_W, _ATTN_B = ("wq", "wk", "wv", "wo"), ("bq", "bv", "bo")
# the weight matrices (``layers.linear`` reads a lane's instance through
# views); every other leaf is a per-lane row under lane groups
MATRICES = (*_ATTN_W, *(f"x_{k}" for k in _ATTN_W), "w1", "w2")
MATMUL_LEAVES = (*MATRICES, *_ATTN_B, *(f"x_{k}" for k in _ATTN_B), "b1", "b2")
LAYER_GROUPS = ("enc_layers", "dec_layers")


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _attn_shapes(cfg: ModelConfig, n: int, prefix: str = "") -> dict:
    m, d, hq, hk = cfg.num_instances, cfg.d_model, cfg.num_heads * cfg.head_dim, \
        cfg.num_kv_heads * cfg.head_dim
    return {f"{prefix}wq": ((n, m, d, hq), "fan_in"), f"{prefix}wk": ((n, m, d, hk), "fan_in"),
            f"{prefix}wv": ((n, m, d, hk), "fan_in"), f"{prefix}wo": ((n, m, hq, d), "fan_in"),
            f"{prefix}bq": ((n, m, hq), "zeros"), f"{prefix}bv": ((n, m, hk), "zeros"),
            f"{prefix}bo": ((n, m, d), "zeros")}


def _layer_shapes(cfg: ModelConfig, n: int, norms: tuple[str, ...], cross: bool) -> dict:
    m, d, ff = cfg.num_instances, cfg.d_model, cfg.d_ff
    p = {}
    for k in norms:
        p[f"{k}_s"], p[f"{k}_b"] = ((n, m, d), "ones"), ((n, m, d), "zeros")
    p.update({"w1": ((n, m, d, ff), "fan_in"), "b1": ((n, m, ff), "zeros"),
              "w2": ((n, m, ff, d), "fan_in"), "b2": ((n, m, d), "zeros")})
    p.update(_attn_shapes(cfg, n))
    if cross:
        p.update(_attn_shapes(cfg, n, "x_"))
    return p


def _shapes(cfg: ModelConfig) -> dict:
    """(shape, init) of every leaf, the reference's tree (layer groups
    stacked on a leading L axis)."""
    m, d, v = cfg.num_instances, cfg.d_model, cfg.vocab_size
    enc_l = cfg.encoder_layers or cfg.num_layers
    return {
        "embed": ((m, v, d), "normal"),
        "pos_embed": ((m, cfg.max_target_positions or 4608, d), "normal"),
        "enc_layers": _layer_shapes(cfg, enc_l, ("ln1", "ln2"), False),
        "enc_ln_s": ((m, d), "ones"), "enc_ln_b": ((m, d), "zeros"),
        "dec_layers": _layer_shapes(cfg, cfg.num_layers, ("ln1", "ln_x", "ln2"), True),
        "final_ln_s": ((m, d), "ones"), "final_ln_b": ((m, d), "zeros"),
    }


def _dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    return torch_dtype(cfg.dtype if name in MATMUL_LEAVES else cfg.param_dtype)


def storage_dtypes(cfg: ModelConfig, tree: dict) -> dict:
    """Cast a parameter tree to the port's storage dtypes."""
    par = torch_dtype(cfg.param_dtype)
    return {g: ({k: v.to(_dtype(cfg, k)) for k, v in leaf.items()} if g in LAYER_GROUPS
                else leaf.to(par)) for g, leaf in tree.items()}


def init(cfg: ModelConfig, generator, device: torch.device, *,
         train: bool = False) -> MergedParams:
    """Random parameters with the reference's distributions, in the
    port's storage dtypes, on ``device``, each leaf drawn a layer at a
    time (``common.draw_leaf``).  ``generator``: one ``torch.Generator``
    or a list of M, one an instance (the model then equals M one-instance
    draws merged, bit for bit, written in place).  ``train`` gives the
    trainable form (every leaf drawn in param_dtype, requiring a
    gradient: ``common.training_params``)."""
    dev, par = torch.device(device), torch_dtype(cfg.param_dtype)
    tree = {}
    for group, leaf in _shapes(cfg).items():
        if group in LAYER_GROUPS:
            tree[group] = {k: draw_leaf(k, shape, init_, par if train else _dtype(cfg, k), True,
                                        generator, dev, par)
                           for k, (shape, init_) in leaf.items()}
        else:
            shape, init_ = leaf
            tree[group] = draw_leaf(group, shape, init_, par, False, generator, dev, par)
    return training_params(cfg, tree) if train else MergedParams(tree)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _sinusoid(n: int, d: int) -> np.ndarray:
    """The encoder's positions, computed in float64 by numpy and cast to
    f32, as the reference computes them."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    inv = np.exp(-np.log(10000.0) * dim / max(d // 2 - 1, 1))
    ang = pos * inv
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


def _layer(params, group: str, i: int, groups: L.LaneGroups | None) -> dict:
    """Layer ``i`` of a layer group, its small leaves (norms, biases) as
    per-lane rows under lane groups."""
    lay = params[group]
    return _lane_rows({k: lay[k][i] for k in lay.keys()}, groups, MATRICES)


def _ln(cfg, x, p, name):
    return L.layer_norm_rowwise(x, p[f"{name}_s"], p[f"{name}_b"], cfg.norm_eps)


def _proj(cfg, x, p, prefix, groups, kv_x=None):
    """q, k, v (M, B, S, heads, hd) of an attention: q from ``x``, k and v
    from ``kv_x`` (default ``x``); no k bias, as in the reference."""
    m, b, s, _ = x.shape
    hd = cfg.head_dim
    kv_x = x if kv_x is None else kv_x
    skv = kv_x.shape[2]
    q = L.linear(x, p[f"{prefix}wq"], p[f"{prefix}bq"], groups)
    k = L.linear(kv_x, p[f"{prefix}wk"], None, groups)
    v = L.linear(kv_x, p[f"{prefix}wv"], p[f"{prefix}bv"], groups)
    return (q.reshape(m, b, s, cfg.num_heads, hd), k.reshape(m, b, skv, cfg.num_kv_heads, hd),
            v.reshape(m, b, skv, cfg.num_kv_heads, hd))


def _out(x, o, p, prefix, groups):
    m, b, s = o.shape[:3]
    return x + L.linear(o.reshape(m, b, s, -1), p[f"{prefix}wo"], p[f"{prefix}bo"], groups)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _bidirectional(q, k, v):
    """Every query over every key (positions 0 .. from both sides, no
    mask): the reference's ``flash_attention(..., causal=False)`` in its
    XLA form."""
    m, b, sq = q.shape[:3]
    pos = lambda n: torch.arange(n, dtype=torch.int32, device=q.device).expand(m, b, n)
    return L.flash_attention_plain(q, k, v, pos(sq), pos(k.shape[2]), causal=False)


def encode(cfg: ModelConfig, params, frame_embeds, groups: L.LaneGroups | None = None):
    """frame_embeds (M, B, F, D) stub conv features -> encoder states (M,
    B, F, D) in cfg.dtype (row i on instance ``groups.t[i]`` under lane
    groups).  Serving: the attention is the chunk-attention kernel over
    one chunk of F rows with no cache, no mask."""
    zero = torch.zeros(frame_embeds.shape[:2], dtype=torch.int32, device=frame_embeds.device)
    return _encoder(cfg, params, frame_embeds, groups, lambda q, k, v: K.chunk_prefill_attention(
        q, k, v, zero, s_cache=0, causal=False))


def encode_seq(cfg: ModelConfig, params, frame_embeds):
    """:func:`encode` in the reference's XLA form (training and a prefill
    from scratch): the attention is :func:`_bidirectional`, no kernel."""
    return _encoder(cfg, params, frame_embeds, None, _bidirectional)


def _encoder(cfg: ModelConfig, params, frame_embeds, groups, attend):
    """The encoder stack with ``attend(q, k, v)`` as its attention."""
    fr, d = frame_embeds.shape[2:]
    act = torch_dtype(cfg.dtype)
    sin = torch.from_numpy(_sinusoid(fr, d)).to(device=frame_embeds.device, dtype=act)
    x = frame_embeds.to(act) + sin
    for i in range(cfg.encoder_layers or cfg.num_layers):
        p = _layer(params, "enc_layers", i, groups)
        q, k, v = _proj(cfg, _ln(cfg, x, p, "ln1"), p, "", groups)
        x = _out(x, attend(q, k, v), p, "", groups)
        x = x + L.gelu_mlp(_ln(cfg, x, p, "ln2"), p["w1"], p["b1"], p["w2"], p["b2"], groups)
    top = {k: params[k] if groups is None else groups.rows(params[k])
           for k in ("enc_ln_s", "enc_ln_b")}
    return _ln(cfg, x, top, "enc_ln")


def _cross_attention(q, k, v):
    """Every query of q (M, B, C, H, hd) over all F frames of k, v (M, B,
    F, KVH, hd), no mask; f32 scores, p in V's dtype, f32 sums.  Both
    products are ``ops.fused_matmul`` over one (C * G, ·) block per lane
    and kv head (its f32 path sums in one order whatever the block
    count); the softmax's sum is the product's extra column of ones.
    Returns (M, B, C, H, hd) in q's dtype."""
    m, b, c, h, hd = q.shape
    fr, kvh = k.shape[2], k.shape[3]
    g = h // kvh
    n = m * b * kvh
    qg = q.reshape(m, b, c, kvh, g, hd).permute(0, 1, 3, 2, 4, 5).reshape(n, c * g, hd)
    kt = k.permute(0, 1, 3, 4, 2).reshape(n, hd, fr)
    s = K.fused_matmul(qg.float().contiguous(), kt.float().contiguous()) / math.sqrt(hd)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    ones = torch.ones((m, b, kvh, fr, 1), dtype=torch.float32, device=v.device)
    v1 = torch.cat([v.permute(0, 1, 3, 2, 4).float(), ones], dim=-1).reshape(n, fr, hd + 1)
    pv = K.fused_matmul(p.to(v.dtype).float(), v1)
    o = pv[..., :hd] / pv[..., hd:]
    return o.reshape(m, b, kvh, c, g, hd).permute(0, 1, 3, 2, 4, 5).reshape(
        m, b, c, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# the whole sequence: training and a prefill from scratch
# ---------------------------------------------------------------------------


def _positions(tokens):
    m, b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32, device=tokens.device).expand(m, b, s)


def _dec_embed(cfg: ModelConfig, params, tokens):
    """Token embeddings plus the learned positions 0 .. S - 1."""
    act = torch_dtype(cfg.dtype)
    s = tokens.shape[2]
    return L.embed(tokens, params["embed"], act) + params["pos_embed"][:, None, :s].to(act)


def _dec_layer_seq(cfg: ModelConfig, p, x, enc, positions):
    """One decoder layer over the whole sequence: causal self-attention,
    the cross-attention over every frame of ``enc``, the MLP.  Returns
    (x, k, v, cross k, cross v)."""
    q, k, v = _proj(cfg, _ln(cfg, x, p, "ln1"), p, "", None)
    x = _out(x, L.flash_attention_plain(q, k, v, positions, positions), p, "", None)
    xq, xk, xv = _proj(cfg, _ln(cfg, x, p, "ln_x"), p, "x_", None, kv_x=enc)
    x = _out(x, _bidirectional(xq, xk, xv), p, "x_", None)
    x = x + L.gelu_mlp(_ln(cfg, x, p, "ln2"), p["w1"], p["b1"], p["w2"], p["b2"])
    return x, k, v, xk, xv


def _final_logits(cfg: ModelConfig, params, x):
    """Final layer norm, then the tied head (``embed``ᵀ) in f32."""
    n = L.layer_norm_rowwise(x, params["final_ln_s"], params["final_ln_b"], cfg.norm_eps)
    return L.unembed(n, params["embed"].transpose(-1, -2))


def decode_full(cfg: ModelConfig, params, tokens, enc_out, *, remat: bool = False):
    """The teacher-forced decoder over tokens (M, B, S) reading the
    encoder states ``enc_out``: logits (M, B, S, V) f32.  With ``remat``
    each layer runs under activation checkpointing."""
    x = _dec_embed(cfg, params, tokens)
    positions = _positions(tokens)
    for i in range(cfg.num_layers):
        x = L.remat(lambda xc, enc, i=i: _dec_layer_seq(
            cfg, _layer(params, "dec_layers", i, None), xc, enc, positions)[0], remat)(x, enc_out)
    return _final_logits(cfg, params, x)


def forward(cfg: ModelConfig, params, tokens, frame_embeds, *, remat: bool = False):
    """Whole-sequence forward (training): :func:`encode_seq` then
    :func:`decode_full`; logits (M, B, S, V) f32."""
    return decode_full(cfg, params, tokens, encode_seq(cfg, params, frame_embeds), remat=remat)


def prefill(cfg: ModelConfig, params, tokens, frame_embeds, *, cache_len: int | None = None):
    """The frames and a whole prompt from scratch: (last logits (M, B, V)
    f32, the decode cache ``{"self": KVCache, "cross_k", "cross_v"}``):
    the self ring ``cache_len`` long (default the prompt) holding the
    prompt from slot 0, the cross K/V over every frame."""
    m, b, s = tokens.shape
    cache_len = cache_len or s
    if cache_len < s:
        raise ValueError(f"a prompt of {s} does not fit a {cache_len}-slot cache")
    enc = encode_seq(cfg, params, frame_embeds)
    cache = make_cache(cfg, m, b, cache_len, tokens.device, frames=enc.shape[2])
    x = _dec_embed(cfg, params, tokens)
    positions = _positions(tokens)
    for i in range(cfg.num_layers):
        x, k, v, xk, xv = _dec_layer_seq(cfg, _layer(params, "dec_layers", i, None), x, enc,
                                         positions)
        cache["self"].k[i, :, :, :s] = k
        cache["self"].v[i, :, :, :s] = v
        cache["cross_k"][i] = xk
        cache["cross_v"][i] = xv
    return _final_logits(cfg, params, x[:, :, -1:])[:, :, 0], cache


# ---------------------------------------------------------------------------
# chunked prefill (serving admission)
# ---------------------------------------------------------------------------


def init_chunk_carry(cfg: ModelConfig, m: int, b: int, cache_len: int, device) -> dict:
    return {"cache": make_cache(cfg, m, b, cache_len, device)}


def chunk_carry_axes(cfg: ModelConfig) -> dict:
    return {"cache": cache_axes(cfg)}


def prefill_chunk(cfg: ModelConfig, params, batch, carry, offset, *,
                  instances: list[int] | None = None) -> dict:
    """One decoder chunk of a state-carrying prefill.

    batch["tokens"] (M, B, C) at positions offset .. offset + C - 1,
    batch["frames"] (M, B, F, D).  The encoder runs on the frames, and
    each layer's cross K/V of every lane with a real row in the chunk is
    rewritten into the carry; the decoder's self-attention attends over
    [cache so far, chunk] and appends its k / v at the ring slots, in
    place.  batch["valid"] (M, B, C), when present, marks the real rows:
    the others never reach the cache, and a lane with none keeps its
    cross K/V.  ``instances`` maps row i of the batch to row
    ``instances[i]`` of the merged model (per-lane weight views)."""
    tokens, frames = batch["tokens"], batch["frames"]
    valid = batch.get("valid")
    cache = carry["cache"]
    m, b, c = tokens.shape
    act = torch_dtype(cfg.dtype)
    dev = tokens.device
    groups = None
    if instances is not None:
        groups = L.LaneGroups(instances, params["embed"].shape[0], dev)
    enc = encode(cfg, params, frames, groups)
    positions = offset[..., None] + torch.arange(c, dtype=offset.dtype, device=dev)
    table = params["pos_embed"]
    inst = groups.t if groups is not None else torch.arange(m, device=dev)
    pidx = positions.clamp(0, table.shape[1] - 1).long()
    x = L.embed(tokens, params["embed"], act, instances) + table[inst[:, None, None], pidx].to(act)
    s_cache = cache["self"].k.shape[3]
    index = L.chunk_write_index(positions, s_cache, 0, valid)
    lane_ok = None if valid is None else valid.any(-1)[..., None, None, None]
    for i in range(cfg.num_layers):
        p = _layer(params, "dec_layers", i, groups)
        ck, cv = cache["self"].k[i], cache["self"].v[i]
        q, k, v = _proj(cfg, _ln(cfg, x, p, "ln1"), p, "", groups)
        o = K.chunk_prefill_attention(q, torch.cat([ck, k.to(ck.dtype)], dim=2),
                                      torch.cat([cv, v.to(cv.dtype)], dim=2), offset,
                                      s_cache=s_cache)
        x = _out(x, o, p, "", groups)
        xq, xk, xv = _proj(cfg, _ln(cfg, x, p, "ln_x"), p, "x_", groups, kv_x=enc)
        x = _out(x, _cross_attention(xq, xk, xv), p, "x_", groups)
        x = x + L.gelu_mlp(_ln(cfg, x, p, "ln2"), p["w1"], p["b1"], p["w2"], p["b2"], groups)
        L.cache_append_chunk(ck, k, positions, index=index)
        L.cache_append_chunk(cv, v, positions, index=index)
        for dst, new in ((cache["cross_k"][i], xk), (cache["cross_v"][i], xv)):
            new = new.to(dst.dtype)
            dst.copy_(new if lane_ok is None else torch.where(lane_ok, new, dst))
    return carry


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _decode_trunk(cfg: ModelConfig, params, cache, tokens, pos, alive=None):
    """The decoder over one token per lane; x (M, B, D) out.  The ring
    append of a lane whose ``alive`` is False is skipped."""
    m, b, _ = tokens.shape
    act = torch_dtype(cfg.dtype)
    table = params["pos_embed"]
    rows = torch.arange(m, device=tokens.device)[:, None]
    pe = table[rows, pos.clamp(0, table.shape[1] - 1).long()]                 # (M, B, D)
    x = L.embed(tokens, params["embed"], act)[:, :, 0] + pe.to(act)
    kv, s_cache = cache["self"], cache["self"].k.shape[3]
    slot = pos % s_cache
    kv_len = torch.clamp(pos + 1, max=s_cache)
    frames = torch.full_like(kv_len, cache["cross_k"].shape[3])
    h, hd = cfg.num_heads, cfg.head_dim
    for i in range(cfg.num_layers):
        p = _layer(params, "dec_layers", i, None)
        q, k, v = _proj(cfg, _ln(cfg, x[:, :, None], p, "ln1"), p, "", None)
        L.cache_update_one(kv.k[i], k, slot, alive)
        L.cache_update_one(kv.v[i], v, slot, alive)
        o = K.decode_attention(q[:, :, 0], kv.k[i], kv.v[i], kv_len)
        x = x + L.linear(o.reshape(m, b, h * hd), p["wo"], p["bo"])
        n = _ln(cfg, x, p, "ln_x")
        xq = L.linear(n, p["x_wq"], p["x_bq"]).reshape(m, b, h, hd)
        o = K.decode_attention(xq, cache["cross_k"][i], cache["cross_v"][i], frames)
        x = x + L.linear(o.reshape(m, b, h * hd), p["x_wo"], p["x_bo"])
        x = x + L.gelu_mlp(_ln(cfg, x, p, "ln2"), p["w1"], p["b1"], p["w2"], p["b2"])
    return x


def decode_step(cfg: ModelConfig, params, cache, tokens, pos, *, alive=None):
    """One decoder token.  tokens (M, B, 1); pos (M, B) int32 = index of
    this token.  Returns (logits (M, B, V) f32, cache updated in place)."""
    x = _decode_trunk(cfg, params, cache, tokens, pos, alive)
    return _final_logits(cfg, params, x), cache


def decode_step_sample(cfg: ModelConfig, params, cache, tokens, pos, *, alive=None):
    """Greedy decode step: (next token (M, B) int32, cache updated in
    place); ties go to the first index."""
    logits, cache = decode_step(cfg, params, cache, tokens, pos, alive=alive)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def make_cache(cfg: ModelConfig, m: int, b: int, context_len: int, device, *,
               frames: int | None = None) -> dict:
    """The grid's decode cache: the self-attention ring (L, M, B, S, KVH,
    hd) and the cross-attention K/V (L, M, B, F, KVH, hd), F = ``frames``
    (default ``cfg.num_audio_frames``), in cfg.dtype."""
    act = torch_dtype(cfg.dtype)
    shape = (cfg.num_layers, m, b, frames or cfg.num_audio_frames, cfg.num_kv_heads,
             cfg.head_dim)
    return {"self": L.make_kv_cache(cfg.num_layers, m, b, context_len, cfg.num_kv_heads,
                                    cfg.head_dim, act, device),
            "cross_k": torch.zeros(shape, dtype=act, device=device),
            "cross_v": torch.zeros(shape, dtype=act, device=device)}


def cache_axes(cfg: ModelConfig) -> dict:
    """Logical axes of the cache leaves (the reference's)."""
    ax = ("layers", "instances", "batch", "cache_seq", "kv_heads", "kv_hd")
    return {"self": KVCache(k=ax, v=ax), "cross_k": ax, "cross_v": ax}
