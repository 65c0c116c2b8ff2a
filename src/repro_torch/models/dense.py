"""Dense llama-family decoder (port of ``repro.models.dense``; tinyllama,
deepseek-67b, granite-3-2b, qwen1.5-0.5b).

Fusion-aware: parameters carry a leading instances axis M, tokens are
(M, B, S).  The layer stack is a Python loop over params stacked on a
leading L axis.  Decode layers, greedy logits and chunk attention go
through ``kernels/ops.py`` (the Hopper kernels on CUDA tensors, their
plain versions on CPU tensors); the other matrix products are
``torch.matmul``, as the reference leaves them to XLA.

Caches are updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.models import layers as L
from repro_torch.models.common import Factory, MergedParams
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
         device: torch.device) -> MergedParams:
    """Random parameters with the reference's distributions, drawn from
    ``generator`` (on ``device``), in the port's storage dtypes.

    The fan-in of a layer-stacked (L, M, D, F) leaf is D, as in the
    reference, which draws each layer's (M, D, F) leaf separately."""
    f = Factory(generator, torch_dtype(cfg.param_dtype), torch.device(device))
    return MergedParams(storage_dtypes(cfg, build_params(cfg, f)))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _layer(params, i: int) -> dict:
    lay = params["layers"]
    return {k: lay[k][i] for k in lay.keys()}


def _head(cfg, params):
    return (params["embed"].transpose(-1, -2) if cfg.tie_embeddings
            else params["lm_head"])


def _embed_in(cfg, params, tokens, instances=None):
    return L.embed(tokens, params["embed"], torch_dtype(cfg.dtype), instances)


def init_chunk_carry(cfg: ModelConfig, m: int, b: int, cache_len: int, device) -> dict:
    return {"cache": make_cache(cfg, m, b, cache_len, device)}


def prefill_chunk(cfg: ModelConfig, params, batch, carry, offset, *,
                  instances: list[int] | None = None) -> dict:
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
                                 valid=batch.get("valid"), instances=instances)


def _prefill_chunk_embeds(cfg: ModelConfig, params, x, carry, offset, valid=None,
                          instances=None) -> dict:
    """Chunk body on precomputed input embeddings.  What every layer
    shares -- RoPE tables, cache slots, per-lane norm and bias rows -- is
    computed once per call."""
    cache = carry["cache"]
    m, b, c, _ = x.shape
    positions = offset[..., None] + torch.arange(c, dtype=offset.dtype,
                                                 device=offset.device)
    s_cache = cache.k.shape[3]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps = cfg.norm_eps
    lay = params["layers"]
    groups = None
    if instances is not None:
        groups = L.LaneGroups(instances, lay["wq"].shape[1], x.device)
    per_lane = {k: (groups.rows(lay[k], 1) if groups else lay[k])
                for k in ("attn_norm", "mlp_norm", "bq", "bk", "bv") if k in lay}
    cos, sin = L.rope_tables(positions, hd, cfg.rope_theta, x.dtype)
    index = L.chunk_write_index(positions, s_cache, 0, valid)
    for i in range(cfg.num_layers):
        lp = {k: lay[k][i] for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}
        pl = {k: v[i] for k, v in per_lane.items()}
        ck, cv = cache.k[i], cache.v[i]
        n = L.rms_norm(x, pl["attn_norm"], eps)
        q = L.linear(n, lp["wq"], pl.get("bq"), groups).reshape(m, b, c, h, hd)
        k = L.linear(n, lp["wk"], pl.get("bk"), groups).reshape(m, b, c, kvh, hd)
        v = L.linear(n, lp["wv"], pl.get("bv"), groups).reshape(m, b, c, kvh, hd)
        q = L.rope_apply(q, cos, sin)
        k = L.rope_apply(k, cos, sin)
        k_all = torch.cat([ck, k.to(ck.dtype)], dim=2)
        v_all = torch.cat([cv, v.to(cv.dtype)], dim=2)
        o = K.chunk_prefill_attention(q, k_all, v_all, offset, s_cache=s_cache,
                                      window=cfg.sliding_window)
        x = x + L.linear(o.reshape(m, b, c, h * hd), lp["wo"], groups=groups)
        nn_ = L.rms_norm(x, pl["mlp_norm"], eps)
        x = x + L.swiglu_mlp(nn_, lp["w_gate"], lp["w_up"], lp["w_down"], groups)
        L.cache_append_chunk(ck, k, positions, index=index)
        L.cache_append_chunk(cv, v, positions, index=index)
    return carry


def _decode_layers(cfg: ModelConfig, params, cache: KVCache, x, pos, alive=None):
    """The decode-layer kernel over the stack; x (M, B, D) residual."""
    for i in range(cfg.num_layers):
        x, _, _ = K.decode_layer(
            _layer(params, i), x, cache.k[i], cache.v[i], pos,
            num_heads=cfg.num_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, window=cfg.sliding_window,
            eps=cfg.norm_eps, alive=alive)
    return x


def decode_step(cfg: ModelConfig, params, cache: KVCache, tokens, pos, *, alive=None):
    """One decode step.  tokens (M, B, 1); pos (M, B) int32 = index of
    this token.  Returns (logits (M, B, V) f32, cache updated in place)."""
    x = _embed_in(cfg, params, tokens)[:, :, 0]
    x = _decode_layers(cfg, params, cache, x, pos, alive)
    n = L.rms_norm(x[:, :, None], params["final_norm"], cfg.norm_eps)
    return L.unembed(n, _head(cfg, params))[:, :, 0], cache


def decode_step_sample(cfg: ModelConfig, params, cache: KVCache, tokens, pos, *,
                       alive=None):
    """Greedy decode step: (next token (M, B) int32, cache updated in
    place).  Final norm, logits and argmax are one fused kernel."""
    x = _embed_in(cfg, params, tokens)[:, :, 0]
    x = _decode_layers(cfg, params, cache, x, pos, alive)
    head = _head(cfg, params)
    if not head.is_contiguous():
        head = head.contiguous()
    tok = K.logits_sample(x, params["final_norm"], head, eps=cfg.norm_eps)
    return tok, cache


def make_cache(cfg: ModelConfig, m: int, b: int, context_len: int, device) -> KVCache:
    s_cache = cfg.sliding_window if cfg.sliding_window else context_len
    return L.make_kv_cache(cfg.num_layers, m, b, s_cache, cfg.num_kv_heads,
                           cfg.head_dim, torch_dtype(cfg.dtype), device)
