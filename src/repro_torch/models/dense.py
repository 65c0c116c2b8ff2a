"""Dense llama-family decoder (port of ``repro.models.dense``; tinyllama,
deepseek-67b, granite-3-2b, qwen1.5-0.5b).

Fusion-aware: parameters carry a leading instances axis M, tokens are
(M, B, S).  The layer stack is a Python loop over params stacked on a
leading L axis.  Decode layers, greedy logits and chunk attention go
through ``kernels/ops.py`` (the Hopper kernels on CUDA tensors, their
plain versions on CPU tensors); the other matrix products are
``torch.matmul``, as the reference leaves them to XLA.

Training and a prefill from scratch (``forward``, ``prefill``) run the
whole sequence through ``seq_block``, whose attention is the reference's
XLA ``flash_attention`` (``layers.flash_attention_plain``; no kernel).

Caches are updated in place.

Tensor parallelism: with a ``TensorParallel`` handle ``tp`` the params
and caches are this rank's shard (``models/shardings.py``): the rank's
query and kv heads, its slice of d_ff and of the vocab.  Column-split
projections need nothing; the sum over the ranks follows each row-split
one (``wo``, ``w_down``), and greedy sampling combines the ranks' vocab
slices.  ``shardings.layer_group`` / ``vocab_group`` say whether a split
applies; layers held whole run as on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.models import layers as L
from repro_torch.models import shardings as S
from repro_torch.models.common import Factory, MergedParams, training_params
from repro_torch.models.layers import KVCache

# layer leaves stored in cfg.dtype (``layers.linear`` casts them to the
# activation dtype at every call, so casting once at load computes the
# same numbers); embed, lm_head and the norm scales stay in param_dtype
MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "bq", "bk", "bv")


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _layer_params(cfg: ModelConfig, f: Factory) -> dict:
    m, d, h, kvh, hd, ff = (cfg.num_instances, cfg.d_model, cfg.num_heads,
                            cfg.num_kv_heads, cfg.head_dim, cfg.d_ff)
    L_ = cfg.num_layers
    p = {
        "attn_norm": f((L_, m, d), init="ones"),
        "wq": f((L_, m, d, h * hd), init="fan_in"),
        "wk": f((L_, m, d, kvh * hd), init="fan_in"),
        "wv": f((L_, m, d, kvh * hd), init="fan_in"),
        "wo": f((L_, m, h * hd, d), init="fan_in"),
        "mlp_norm": f((L_, m, d), init="ones"),
        "w_gate": f((L_, m, d, ff), init="fan_in"),
        "w_up": f((L_, m, d, ff), init="fan_in"),
        "w_down": f((L_, m, ff, d), init="fan_in"),
    }
    if cfg.qkv_bias:
        p["bq"] = f((L_, m, h * hd), init="zeros")
        p["bk"] = f((L_, m, kvh * hd), init="zeros")
        p["bv"] = f((L_, m, kvh * hd), init="zeros")
    return p


def storage_dtypes(cfg: ModelConfig, tree: dict) -> dict:
    """Cast a parameter tree to the port's storage dtypes."""
    act, par = torch_dtype(cfg.dtype), torch_dtype(cfg.param_dtype)
    out = {k: v.to(par) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: v.to(act if k in MATMUL_LEAVES else par)
                     for k, v in tree["layers"].items()}
    return out


def build_params(cfg: ModelConfig, f: Factory) -> dict:
    m, d, v = cfg.num_instances, cfg.d_model, cfg.vocab_size
    p = {
        "embed": f((m, v, d)),
        "layers": _layer_params(cfg, f),
        "final_norm": f((m, d), init="ones"),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = f((m, d, v), init="fan_in")
    return p


def init(cfg: ModelConfig, generator: torch.Generator | None,
         device: torch.device, *, train: bool = False) -> MergedParams:
    """Random parameters with the reference's distributions, drawn from
    ``generator`` (on ``device``), in the port's storage dtypes; with
    ``train``, the trainable form (``common.training_params``).

    The fan-in of a layer-stacked (L, M, D, F) leaf is D, as in the
    reference, which draws each layer's (M, D, F) leaf separately."""
    f = Factory(generator, torch_dtype(cfg.param_dtype), torch.device(device))
    tree = build_params(cfg, f)
    return training_params(cfg, tree) if train else MergedParams(storage_dtypes(cfg, tree))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _layer(params, i: int) -> dict:
    lay = params["layers"]
    return {k: lay[k][i] for k in lay.keys()}


def _head(cfg, params, vtp=None):
    """The unembedding (M, D, V/T) of this rank's vocab slice under the
    vocab group ``vtp``, or the whole (M, D, V) without one."""
    if not cfg.tie_embeddings:
        return params["lm_head"]
    e = params["embed"]
    if vtp is not None:
        v_l = cfg.vocab_size // vtp.size
        e = e.narrow(1, vtp.rank * v_l, v_l)
    return e.transpose(-1, -2)


def _embed_in(cfg, params, tokens, instances=None):
    return L.embed(tokens, params["embed"], torch_dtype(cfg.dtype), instances)


def _positions(tokens):
    m, b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32, device=tokens.device).expand(m, b, s)


def seq_attention(cfg: ModelConfig, lp, x, positions, cos, sin, *, window: int = 0):
    """The attention half of a block over a whole sequence x (M, B, S, D)
    (training and a prefill from scratch): rms -> QKV (+bias) -> RoPE ->
    causal attention with the reference's positional mask
    (``layers.flash_attention_plain``, its XLA ``flash_attention``; no
    kernel) -> out-proj + residual.  Returns (x, k, v) with the rotated k
    and v of the sequence."""
    m, b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = L.linear(n, lp["wq"], lp.get("bq")).reshape(m, b, s, h, hd)
    k = L.linear(n, lp["wk"], lp.get("bk")).reshape(m, b, s, kvh, hd)
    v = L.linear(n, lp["wv"], lp.get("bv")).reshape(m, b, s, kvh, hd)
    q, k = L.rope_apply(q, cos, sin), L.rope_apply(k, cos, sin)
    o = L.flash_attention_plain(q, k, v, positions, positions, window=window)
    return x + L.linear(o.reshape(m, b, s, h * hd), lp["wo"]), k, v


def seq_block(cfg: ModelConfig, lp, x, positions, cos, sin, *, window: int = 0):
    """One block over a whole sequence: :func:`seq_attention`, then
    SwiGLU + residual.  Returns (x, k, v)."""
    x, k, v = seq_attention(cfg, lp, x, positions, cos, sin, window=window)
    nn_ = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + L.swiglu_mlp(nn_, lp["w_gate"], lp["w_up"], lp["w_down"]), k, v


def _logits(cfg: ModelConfig, params, x):
    n = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(n, _head(cfg, params))


def forward(cfg: ModelConfig, params, tokens, *, inputs_embeds=None, positions=None,
            remat: bool = False):
    """Whole-sequence forward (training): logits (M, B, S, V) f32.  With
    ``remat`` each layer runs under activation checkpointing.
    ``inputs_embeds`` (M, B, S, D) and ``positions`` (M, B, S), when
    given, replace the token embeddings and 0 .. S - 1 (vlm's image
    prefix)."""
    x = _embed_in(cfg, params, tokens) if inputs_embeds is None else inputs_embeds
    positions = _positions(tokens) if positions is None else positions
    cos, sin = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta, x.dtype)
    for i in range(cfg.num_layers):
        x = L.remat(lambda xc, i=i: seq_block(cfg, _layer(params, i), xc, positions, cos, sin,
                                              window=cfg.sliding_window)[0], remat)(x)
    return _logits(cfg, params, x)


def prefill(cfg: ModelConfig, params, tokens, *, cache_len: int | None = None):
    """A whole prompt: (logits of the last position (M, B, V) f32, KVCache).

    The cache is ``cache_len`` long (default: the window for a
    sliding-window model, else the prompt length) and laid out
    ring-consistently, so decode continues at pos = S: a longer cache
    holds the prompt from slot 0, a shorter one (S a multiple of it) its
    last ``cache_len`` positions."""
    return prefill_embeds(cfg, params, _embed_in(cfg, params, tokens), _positions(tokens),
                          cache_len=cache_len)


def prefill_embeds(cfg: ModelConfig, params, x, positions, *, cache_len: int | None = None,
                   block=seq_block):
    """:func:`prefill`'s shell over input embeddings x (M, B, S, D) at
    ``positions`` (vlm's image prefix and tokens); ``block(cfg, lp, x,
    positions, cos, sin, window=)`` is a layer (moe's routes its
    experts)."""
    m, b, s, _ = x.shape
    window = cfg.sliding_window
    cache_len = cache_len or (window if window else s)
    if cache_len < s and s % cache_len:
        raise ValueError(f"a prompt of {s} must be a multiple of the {cache_len}-slot ring")
    cos, sin = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta, x.dtype)
    cache = L.make_kv_cache(cfg.num_layers, m, b, cache_len, cfg.num_kv_heads, cfg.head_dim,
                            torch_dtype(cfg.dtype), x.device)
    keep = min(s, cache_len)
    for i in range(cfg.num_layers):
        x, k, v = block(cfg, _layer(params, i), x, positions, cos, sin, window=window)
        cache.k[i, :, :, :keep] = k[:, :, s - keep:]
        cache.v[i, :, :, :keep] = v[:, :, s - keep:]
    return _logits(cfg, params, x[:, :, -1:])[:, :, 0], cache


def init_chunk_carry(cfg: ModelConfig, m: int, b: int, cache_len: int, device,
                     tp=None) -> dict:
    return {"cache": make_cache(cfg, m, b, cache_len, device, tp)}


def prefill_chunk(cfg: ModelConfig, params, batch, carry, offset, *,
                  instances: list[int] | None = None, tp=None) -> dict:
    """One chunk of a state-carrying prefill (serving admission).

    batch["tokens"]: (M, B, C) tokens at absolute positions
    offset .. offset + C - 1 (offset (M, B) int32).  The carry's cache
    holds every earlier position; the chunk attends over
    [cache so far, chunk] and appends its k/v at the ring slots, in
    place.  batch["valid"] (M, B, C) bool, when present, marks the rows
    that are real: the others never reach the cache, and causality keeps
    them invisible to the real queries.  ``instances`` maps row i of the
    batch to row ``instances[i]`` of the merged model (per-lane weight
    views; default: row i)."""
    x = _embed_in(cfg, params, batch["tokens"], instances)
    return _prefill_chunk_embeds(cfg, params, x, carry, offset,
                                 valid=batch.get("valid"), instances=instances, tp=tp)


def _prefill_chunk_embeds(cfg: ModelConfig, params, x, carry, offset, valid=None,
                          instances=None, tp=None) -> dict:
    """Chunk body on precomputed input embeddings.  What every layer
    shares -- RoPE tables, cache slots, per-lane norm and bias rows -- is
    computed once per call.  Under a layer split the chunk attention
    runs on this rank's heads and a sum over the ranks follows ``wo``
    and ``w_down``."""
    ctx = chunk_context(cfg, params, x, carry["cache"], offset, valid, instances,
                        S.layer_group(cfg, tp))
    lay, groups, psum = params["layers"], ctx.groups, ctx.psum
    for i in range(cfg.num_layers):
        x, k, v = chunk_attention(cfg, ctx, params, i, x)
        nn_ = L.rms_norm(x, ctx.per_lane["mlp_norm"][i], cfg.norm_eps)
        x = x + psum(L.swiglu_mlp(nn_, lay["w_gate"][i], lay["w_up"][i], lay["w_down"][i],
                                  groups))
        chunk_append(ctx, i, k, v)
    return carry


@dataclasses.dataclass
class ChunkContext:
    """What every layer of one chunk call shares: the cache, the chunk's
    positions and offsets, RoPE tables, the cache-write index, the lane
    groups and per-lane norm / bias rows, this rank's heads and its sum."""
    cache: KVCache
    offset: torch.Tensor
    positions: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    index: tuple
    groups: L.LaneGroups | None
    per_lane: dict
    heads: int
    kv_heads: int
    psum: Callable


def chunk_context(cfg: ModelConfig, params, x, cache: KVCache, offset, valid=None,
                  instances=None, ltp=None) -> ChunkContext:
    """The shared part of a chunk call over x (M, B, C, D) at ``offset``;
    ``ltp`` the layer group under a layer split, else None."""
    c = x.shape[2]
    positions = offset[..., None] + torch.arange(c, dtype=offset.dtype, device=offset.device)
    lay = params["layers"]
    n_split = 1 if ltp is None else ltp.size
    groups = None
    if instances is not None:
        groups = L.LaneGroups(instances, lay["wq"].shape[1], x.device)
    per_lane = {k: (groups.rows(lay[k], 1) if groups else lay[k])
                for k in ("attn_norm", "mlp_norm", "bq", "bk", "bv") if k in lay}
    cos, sin = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta, x.dtype)
    return ChunkContext(
        cache=cache, offset=offset, positions=positions, cos=cos, sin=sin,
        index=L.chunk_write_index(positions, cache.k.shape[3], 0, valid), groups=groups,
        per_lane=per_lane, heads=cfg.num_heads // n_split,
        kv_heads=cfg.num_kv_heads // n_split,
        psum=(lambda t: t) if ltp is None else ltp.all_reduce_sum)


def chunk_attention(cfg: ModelConfig, ctx: ChunkContext, params, i: int, x):
    """Layer ``i``'s attention over [cache so far, chunk]: rms -> QKV
    (+bias) -> RoPE -> the chunk attention kernel -> out-proj (+ the sum
    over the ranks) + residual.  Returns (x, k, v); the caller appends k
    and v with :func:`chunk_append` once the layer no longer reads the
    cache."""
    lay, groups = params["layers"], ctx.groups
    m, b, c, _ = x.shape
    h, kvh, hd = ctx.heads, ctx.kv_heads, cfg.head_dim
    pl = {k: v[i] for k, v in ctx.per_lane.items()}
    ck, cv = ctx.cache.k[i], ctx.cache.v[i]
    n = L.rms_norm(x, pl["attn_norm"], cfg.norm_eps)
    q = L.linear(n, lay["wq"][i], pl.get("bq"), groups).reshape(m, b, c, h, hd)
    k = L.linear(n, lay["wk"][i], pl.get("bk"), groups).reshape(m, b, c, kvh, hd)
    v = L.linear(n, lay["wv"][i], pl.get("bv"), groups).reshape(m, b, c, kvh, hd)
    q = L.rope_apply(q, ctx.cos, ctx.sin)
    k = L.rope_apply(k, ctx.cos, ctx.sin)
    k_all = torch.cat([ck, k.to(ck.dtype)], dim=2)
    v_all = torch.cat([cv, v.to(cv.dtype)], dim=2)
    o = K.chunk_prefill_attention(q, k_all, v_all, ctx.offset, s_cache=ck.shape[2],
                                  window=cfg.sliding_window)
    x = x + ctx.psum(L.linear(o.reshape(m, b, c, h * hd), lay["wo"][i], groups=groups))
    return x, k, v


def chunk_append(ctx: ChunkContext, i: int, k, v) -> None:
    """Append the chunk's k and v rows of layer ``i`` at their ring slots."""
    L.cache_append_chunk(ctx.cache.k[i], k, ctx.positions, index=ctx.index)
    L.cache_append_chunk(ctx.cache.v[i], v, ctx.positions, index=ctx.index)


def _decode_layers(cfg: ModelConfig, params, cache: KVCache, x, pos, alive=None, tp=None):
    """The decode-layer kernels over the stack; x (M, B, D) residual."""
    ltp = S.layer_group(cfg, tp)
    for i in range(cfg.num_layers):
        x, _, _ = K.decode_layer_sharded(
            _layer(params, i), x, cache.k[i], cache.v[i], pos, tp=ltp,
            num_heads=cfg.num_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, window=cfg.sliding_window,
            eps=cfg.norm_eps, alive=alive)
    return x


def decode_step(cfg: ModelConfig, params, cache: KVCache, tokens, pos, *, alive=None,
                tp=None):
    """One decode step.  tokens (M, B, 1); pos (M, B) int32 = index of
    this token.  Returns (logits (M, B, V) f32, cache updated in place);
    under tensor parallelism every rank gets the whole vocab's logits."""
    x = _embed_in(cfg, params, tokens)[:, :, 0]
    x = _decode_layers(cfg, params, cache, x, pos, alive, tp)
    n = L.rms_norm(x[:, :, None], params["final_norm"], cfg.norm_eps)
    vtp = S.vocab_group(cfg, tp)
    logits = L.unembed(n, _head(cfg, params, vtp))[:, :, 0]
    if vtp is not None:
        logits = vtp.all_gather(logits, dim=-1)
    return logits, cache


def decode_step_sample(cfg: ModelConfig, params, cache: KVCache, tokens, pos, *,
                       alive=None, tp=None):
    """Greedy decode step: (next token (M, B) int32, cache updated in
    place).  Final norm, logits and argmax are one fused kernel (per
    vocab slice under tensor parallelism, then a cross-rank combine)."""
    x = _embed_in(cfg, params, tokens)[:, :, 0]
    x = _decode_layers(cfg, params, cache, x, pos, alive, tp)
    vtp = S.vocab_group(cfg, tp)
    head = _head(cfg, params, vtp)
    if not head.is_contiguous():
        head = head.contiguous()
    tok = K.logits_sample_sharded(x, params["final_norm"], head, tp=vtp, eps=cfg.norm_eps)
    return tok, cache


def cache_axes(cfg: ModelConfig) -> KVCache:
    """Logical axes of the grid cache leaves."""
    ax = ("layers", "instances", "batch", "cache_seq", "kv_heads", "kv_hd")
    return KVCache(k=ax, v=ax)


def chunk_carry_axes(cfg: ModelConfig) -> dict:
    return {"cache": cache_axes(cfg)}


def make_cache(cfg: ModelConfig, m: int, b: int, context_len: int, device,
               tp=None) -> KVCache:
    """The grid's KV cache, (L, M, B, S, KVH, hd); a rank's shard holds its
    kv heads."""
    s_cache = cfg.sliding_window if cfg.sliding_window else context_len
    kvh = cfg.num_kv_heads if tp is None else S.local_kv_heads(cfg, tp.size)
    return L.make_kv_cache(cfg.num_layers, m, b, s_cache, kvh,
                           cfg.head_dim, torch_dtype(cfg.dtype), device)
