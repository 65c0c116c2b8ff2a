"""Token-choice top-k MoE decoder (port of ``repro.models.moe``;
olmoe-1b-7b, qwen3-moe-30b-a3b), on one device.

NetFuse merges M instances into a block-diagonal MoE: instance m's router
only routes to instance m's E experts, so the merged model holds M*E
experts in M routing groups.  The attention is dense's (the chunk
attention kernel in prefill, the decode layer's attention phase in
decode); the FFN is :func:`moe_mlp`.

Routing follows the reference exactly: the f32 router, softmax and
top-k (ties to the lower expert id), the weights renormalised; per
(instance, batch row) the K assignments of every token are sorted by
expert id with a stable sort (masked tokens take the sentinel id E and
sort last), an assignment's position in its expert is its place in the
sorted stream, and it is kept while that position is below the capacity
(``_sorted_keep``).  Chunked prefill carries per-layer, per-expert counts
and an exact-length ``limit``, so a chunked prefill keeps and drops what
one exact-length pass would.  Each token's K expert outputs are scaled
by their weights in the activation dtype and added in the order of the
sorted stream (ascending expert id).

The reference multiplies zero-padded (M, B, E, capacity, D) buffers.
The port computes the same function on the kept rows only: every
(instance, expert) pair is one instance of the NetFuse merged matmul
(``kernels.ops.fused_matmul`` on a free (M*E, D, F) view of ``we_*``),
its rows the kept assignments of that pair, padded to a bound the host
knows from the shapes (no device-to-host read): a row's result does not
depend on how many rows or pairs share the call.

Not ported here: the expert-parallel ``shard_map`` paths, MoE under
tensor parallelism or on the data axis, whole-sequence ``forward`` /
``prefill`` and the load-balance aux loss (they belong with training).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.models import dense
from repro_torch.models import layers as L
from repro_torch.models.common import Factory, MergedParams
from repro_torch.models.layers import KVCache

# leaves stored in cfg.dtype (the reference casts them to the activation
# dtype at every use); the router, the norms, embed and lm_head stay in
# param_dtype (the router runs in f32)
MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "we_gate", "we_up", "we_down")
ATTN_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "bq", "bk", "bv")

torch_dtype = dense.torch_dtype


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _layer_shapes(cfg: ModelConfig) -> dict:
    """(shape, init) of each layer leaf, stacked on a leading L axis."""
    m, d, h, kvh, hd = (cfg.num_instances, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim)
    e, ff, n = cfg.num_experts, cfg.d_ff, cfg.num_layers
    p = {
        "attn_norm": ((n, m, d), "ones"),
        "wq": ((n, m, d, h * hd), "fan_in"),
        "wk": ((n, m, d, kvh * hd), "fan_in"),
        "wv": ((n, m, d, kvh * hd), "fan_in"),
        "wo": ((n, m, h * hd, d), "fan_in"),
        "mlp_norm": ((n, m, d), "ones"),
        "router": ((n, m, d, e), "fan_in"),
        "we_gate": ((n, m, e, d, ff), "fan_in"),
        "we_up": ((n, m, e, d, ff), "fan_in"),
        "we_down": ((n, m, e, ff, d), "fan_in"),
    }
    if cfg.qkv_bias:
        p["bq"] = ((n, m, h * hd), "zeros")
        p["bk"] = ((n, m, kvh * hd), "zeros")
        p["bv"] = ((n, m, kvh * hd), "zeros")
    return p


def _leaf_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    return torch_dtype(cfg.dtype if name in MATMUL_LEAVES else cfg.param_dtype)


def storage_dtypes(cfg: ModelConfig, tree: dict) -> dict:
    """Cast a parameter tree to the port's storage dtypes."""
    par = torch_dtype(cfg.param_dtype)
    out = {k: v.to(par) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: v.to(_leaf_dtype(cfg, k)) for k, v in tree["layers"].items()}
    return out


def init(cfg: ModelConfig, generator: torch.Generator | None,
         device: torch.device) -> MergedParams:
    """Random parameters with the reference's distributions, drawn from
    ``generator`` (on ``device``), in the port's storage dtypes.

    Each leaf is drawn one layer at a time and stored in its storage
    dtype at once, so no leaf is ever whole in f32: olmoe-1b-7b's expert
    weights at M = 4 are 51 GB in bf16 and would be twice that in f32."""
    dev = torch.device(device)
    par = torch_dtype(cfg.param_dtype)

    def leaf(shape, init, dtype, per_layer: bool):
        f = Factory(generator, par, dev)
        if not per_layer:
            return f(shape, init=init).to(dtype)
        out = torch.empty(shape, dtype=dtype, device=dev)
        for i in range(shape[0]):
            out[i] = f(shape[1:], init=init)
        return out

    m, d, v = cfg.num_instances, cfg.d_model, cfg.vocab_size
    tree = {
        "embed": leaf((m, v, d), "normal", par, False),
        "layers": {k: leaf(shape, init_, _leaf_dtype(cfg, k), True)
                   for k, (shape, init_) in _layer_shapes(cfg).items()},
        "final_norm": leaf((m, d), "ones", par, False),
        "lm_head": leaf((m, d, v), "fan_in", par, False),
    }
    return MergedParams(tree)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def capacity(cfg: ModelConfig, s: int) -> int:
    """The reference's static capacity of an exact-length pass over s
    tokens: max(1, ceil(s * K / E * capacity_factor)), in Python floats."""
    return max(1, math.ceil(s * cfg.num_experts_per_tok / cfg.num_experts
                            * cfg.capacity_factor))


def top_k(probs: torch.Tensor, k: int):
    """The k largest of the last axis, ties to the lower index (as
    ``lax.top_k``; ``torch.topk`` promises no order on ties): a stable
    descending sort keeps equal values in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ModelConfig, router, x, *, cap: int, valid=None, counts=None, limit=None):
    """The routing of x (M, B, S, D) by ``router`` (M, D, E) (a row's
    router: per-lane rows under lane groups).  Returns a dict of

    * ``top_e`` / ``top_w`` (M, B, S, K): the experts and their
      renormalised f32 weights;
    * ``order`` (M, B, S*K): the stable argsort of the flat assignment
      stream (sentinel E for a masked token), ``e_sorted`` / ``w_sorted``
      the stream in that order;
    * ``pos``: each sorted assignment's position in its expert, ``keep``:
      the reference's ``_sorted_keep`` (below ``cap``, not a sentinel,
      and with ``counts`` (M, B, E) below ``limit`` (M, B) counting the
      earlier chunks' assignments);
    * ``counts``: ``counts`` advanced by every non-masked assignment, kept
      or dropped (None without ``counts``)."""
    m, b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = torch.matmul(x.float().reshape(m, b * s, d), router.float()).reshape(m, b, s, e)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, k)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    e_flat = top_e.reshape(m, b, s * k)
    w_flat = top_w.reshape(m, b, s * k)
    if valid is not None:
        v_flat = valid[..., None].expand(m, b, s, k).reshape(m, b, s * k)
        e_flat = torch.where(v_flat, e_flat, torch.full_like(e_flat, e))
    eid_flat = e_flat.clamp(max=e - 1)
    new_counts = None
    if counts is not None:
        new_counts = counts.scatter_add(-1, eid_flat, (e_flat < e).to(counts.dtype))
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = e_flat.gather(-1, order)
    w_sorted = w_flat.gather(-1, order)
    ids = torch.arange(e, dtype=e_sorted.dtype, device=x.device).expand(m, b, e).contiguous()
    starts = torch.searchsorted(e_sorted, ids)
    eid = e_sorted.clamp(max=e - 1)
    pos = torch.arange(s * k, device=x.device) - starts.gather(-1, eid)
    keep = (e_sorted < e) & (pos < cap)
    if counts is not None:
        keep = keep & (counts.gather(-1, eid) + pos < limit[..., None])
    return {"top_e": top_e, "top_w": top_w, "order": order, "e_sorted": e_sorted,
            "w_sorted": w_sorted, "eid": eid, "pos": pos, "keep": keep, "counts": new_counts}


# ---------------------------------------------------------------------------
# the experts
# ---------------------------------------------------------------------------


def _expert_rows(cfg: ModelConfig, r: dict, m_w: int, inst, rank, reps: int, t: int):
    """Where each sorted assignment's row lies in the (M_w * E * t + 1, D)
    block of expert inputs.  Pair p = (instance, expert) owns rows
    [p * t, (p + 1) * t); a kept assignment takes its pair's next row (the
    rows of one instance in (lane rank, batch row) order, then stream
    order), a dropped one the last row, which no product reads.  ``inst``
    and ``rank`` (M,) are each row's instance and its rank among the rows
    of that instance; ``reps`` the most rows an instance has."""
    e = cfg.num_experts
    keep, eid, pos = r["keep"], r["eid"], r["pos"]
    m, b = keep.shape[:2]
    n_keep = torch.zeros(m, b, e, dtype=torch.long, device=keep.device)
    n_keep.scatter_add_(-1, eid, keep.long())
    # the exclusive running count over the earlier rows of the same instance
    block = n_keep.new_zeros(m_w, reps * b, e)
    block.view(m_w, reps, b, e)[inst, rank] = n_keep
    before = (block.cumsum(1) - block).view(m_w, reps, b, e)[inst, rank]
    row = (inst.reshape(m, 1, 1) * e + eid) * t + before.gather(-1, eid) + pos
    return torch.where(keep, row, torch.full_like(row, m_w * e * t))


def _combine(y, r: dict, s: int, k: int):
    """Each token's K weighted expert outputs y (M, B, S*K, D) (sorted
    stream order), added in stream order: out = c_0 + c_1 + ... with c_j
    the token's j-th assignment in the stream."""
    m, b, sk, d = y.shape
    inv = torch.argsort(r["order"], dim=-1)                  # flat (token, k) -> stream
    stream_pos = inv.reshape(m, b, s, k).sort(dim=-1).values
    c = y.gather(2, stream_pos.reshape(m, b, s * k, 1).expand(m, b, s * k, d))
    c = c.reshape(m, b, s, k, d)
    out = c[:, :, :, 0]
    for j in range(1, k):
        out = out + c[:, :, :, j]
    return out


def moe_mlp(cfg: ModelConfig, lp, x, *, valid=None, counts=None, limit=None,
            groups: L.LaneGroups | None = None):
    """x (M, B, S, D) -> (M, B, S, D) in x's dtype; with ``counts`` the
    chainable chunked form, returning (out, counts advanced).

    ``lp`` holds this layer's ``router`` (M_w, D, E) and ``we_gate`` /
    ``we_up`` (M_w, E, D, F), ``we_down`` (M_w, E, F, D); with ``groups``
    row i of x reads instance ``groups.t[i]``.  ``valid`` (M, B, S) masks
    junk tokens out of routing; ``counts`` (M, B, E) int32 and ``limit``
    (M, B) int32 are the earlier chunks' assignments and the exact-length
    capacity of each row's request."""
    m, b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    chunked = counts is not None
    cap = s * k if chunked else capacity(cfg, s)
    router = lp["router"] if groups is None else groups.rows(lp["router"])
    r = route(cfg, router, x, cap=cap, valid=valid, counts=counts, limit=limit)

    wg, wu, wd = lp["we_gate"], lp["we_up"], lp["we_down"]
    m_w, ff = wg.shape[0], wg.shape[-1]
    if groups is None:
        inst, rank, reps = torch.arange(m, device=x.device), x.new_zeros(m, dtype=torch.long), 1
    else:
        inst, rank, reps = groups.t, groups.r, groups.reps
    # a row holds at most min(S, cap) assignments of one expert (a token
    # picks an expert once): the rows of a pair, bounded from the shapes
    t = reps * b * min(s, cap)
    rows = _expert_rows(cfg, r, m_w, inst, rank, reps, t)
    tok = r["order"] // k                                    # token of each assignment
    src = (torch.arange(m * b, device=x.device).reshape(m, b, 1) * s + tok).reshape(-1)
    xb = x.new_zeros(m_w * e * t + 1, d)
    xb[rows.reshape(-1)] = x.reshape(m * b * s, d)[src]
    xe = xb[:-1].view(m_w * e, t, d)
    h = (F.silu(K.fused_matmul(xe, wg.reshape(m_w * e, d, ff)))
         * K.fused_matmul(xe, wu.reshape(m_w * e, d, ff)))
    ye = K.fused_matmul(h, wd.reshape(m_w * e, ff, d)).reshape(m_w * e * t, d)
    y = ye[rows.clamp(max=m_w * e * t - 1)]                  # (M, B, S*K, D)
    y = y * r["keep"][..., None].to(y.dtype)
    y = y * r["w_sorted"][..., None].to(y.dtype)
    out = _combine(y, r, s, k)
    return (out, r["counts"]) if chunked else out


def _experts_of(lay, i: int) -> dict:
    return {n: lay[n][i] for n in ("router", "we_gate", "we_up", "we_down")}


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def make_cache(cfg: ModelConfig, m: int, b: int, context_len: int, device) -> KVCache:
    """The grid's KV cache, (L, M, B, S, KVH, hd)."""
    return dense.make_cache(cfg, m, b, context_len, device)


def cache_axes(cfg: ModelConfig) -> KVCache:
    return dense.cache_axes(cfg)


def init_chunk_carry(cfg: ModelConfig, m: int, b: int, cache_len: int, device) -> dict:
    """The cache and, per layer (routers are independent per layer), the
    per-expert assignment counts of the earlier chunks."""
    return {"cache": make_cache(cfg, m, b, cache_len, device),
            "counts": torch.zeros(cfg.num_layers, m, b, cfg.num_experts, dtype=torch.int32,
                                  device=device)}


def chunk_carry_axes(cfg: ModelConfig) -> dict:
    return {"cache": cache_axes(cfg), "counts": ("layers", "instances", "batch", None)}


def prefill_chunk(cfg: ModelConfig, params, batch, carry, offset, *,
                  instances: list[int] | None = None) -> dict:
    """One chunk of a state-carrying prefill with exact-length-equivalent
    routing.  batch["tokens"] (M, B, C) at positions offset .. offset + C
    - 1; batch["moe_limit"] (M, B) int32 the capacity an exact-length
    prefill of each request's real token count would use; batch["valid"]
    (M, B, C), when present, the real rows.  The cache and the counts
    are updated in place; ``instances`` maps row i to instance
    ``instances[i]``."""
    x = dense._embed_in(cfg, params, batch["tokens"], instances)
    valid, limit = batch.get("valid"), batch["moe_limit"]
    ctx = dense.chunk_context(cfg, params, x, carry["cache"], offset, valid, instances)
    lay, counts = params["layers"], carry["counts"]
    for i in range(cfg.num_layers):
        x, k, v = dense.chunk_attention(cfg, ctx, params, i, x)
        n = L.rms_norm(x, ctx.per_lane["mlp_norm"][i], cfg.norm_eps)
        y, new_counts = moe_mlp(cfg, _experts_of(lay, i), n, valid=valid, counts=counts[i],
                                limit=limit, groups=ctx.groups)
        counts[i].copy_(new_counts)
        x = x + y
        dense.chunk_append(ctx, i, k, v)
    return carry


def _decode_layers(cfg: ModelConfig, params, cache: KVCache, x, pos, alive=None):
    """The stack over x (M, B, D): the decode layer's attention phase
    (ring append in place), its residual, then the MoE FFN."""
    lay = params["layers"]
    for i in range(cfg.num_layers):
        lp = {n: lay[n][i] for n in ATTN_LEAVES if n in lay}
        part, _, _ = K.decode_layer_attn(lp, x, cache.k[i], cache.v[i], pos,
                                         num_heads=cfg.num_heads, head_dim=cfg.head_dim,
                                         rope_theta=cfg.rope_theta, window=cfg.sliding_window,
                                         eps=cfg.norm_eps, alive=alive)
        x = x + part
        n = L.rms_norm(x, lay["mlp_norm"][i], cfg.norm_eps)
        x = x + moe_mlp(cfg, _experts_of(lay, i), n[:, :, None])[:, :, 0]
    return x


def decode_step(cfg: ModelConfig, params, cache: KVCache, tokens, pos, *, alive=None):
    """One decode step.  tokens (M, B, 1); pos (M, B) int32.  Returns
    (logits (M, B, V) f32, cache updated in place)."""
    x = dense._embed_in(cfg, params, tokens)[:, :, 0]
    x = _decode_layers(cfg, params, cache, x, pos, alive)
    n = L.rms_norm(x[:, :, None], params["final_norm"], cfg.norm_eps)
    return L.unembed(n, params["lm_head"])[:, :, 0], cache


def decode_step_sample(cfg: ModelConfig, params, cache: KVCache, tokens, pos, *, alive=None):
    """Greedy decode step: (next token (M, B) int32, cache updated in
    place); final norm, logits and argmax in one fused kernel."""
    x = dense._embed_in(cfg, params, tokens)[:, :, 0]
    x = _decode_layers(cfg, params, cache, x, pos, alive)
    return K.logits_sample(x, params["final_norm"], params["lm_head"], eps=cfg.norm_eps), cache
