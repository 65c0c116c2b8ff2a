"""Token-choice top-k MoE decoder (port of ``repro.models.moe``;
olmoe-1b-7b, qwen3-moe-30b-a3b), on one device and on a (data, model)
mesh.

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

On a mesh (``tp``, ``models/shardings.py``'s moe rules) the attention
runs on the rank's heads as dense's does (a sum after ``wo``), and the
experts are expert-parallel, the reference's ``_row_dispatch_window`` +
``_moe_mlp_ep_shmap``: every rank routes every token with the whole
router, only the kept assignments whose expert lies in the rank's window
[r E/T, (r+1) E/T) take rows of its merged matmul, the window's weighted
outputs combine in stream order (zero for the others), and one sum over
the ranks in token space follows.  The reference's GSPMD placement
(``experts_compute: "model"``) and its ``"ep"`` placement compute the
same function; the port has this one.  Its ``_shmap_rows`` needs no
counterpart: a rank's rows are local already.  The data axis slices the
instance rows (or slots) like every family's.

Training and a prefill from scratch (``forward``, ``prefill``) run the
whole sequence: dense's whole-sequence attention (``dense.seq_attention``,
no kernel), then :func:`moe_mlp` at the capacity of the whole sequence,
whose expert products run the merged-matmul kernel under its autograd
Function (``fused_matmul.Merged``: the backward's dx and dw products
launch the same kernel).  ``forward`` also returns the Switch
load-balance aux of the reference (:func:`load_balance_aux`), averaged
over the layers.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.models import dense
from repro_torch.models import layers as L
from repro_torch.models import shardings as S
from repro_torch.models.common import MergedParams, draw_leaf, training_params
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


def init(cfg: ModelConfig, generator, device: torch.device, cut=None, *,
         train: bool = False) -> MergedParams:
    """Random parameters with the reference's distributions, in the
    port's storage dtypes, on ``device``; with ``train``, the trainable
    form (every leaf drawn in param_dtype, requiring a gradient:
    ``common.training_params``), the same draws before the cast.

    ``generator`` is one ``torch.Generator`` (each layer of a leaf drawn
    for all M instances at once) or a list of M, one an instance: row j of
    every leaf is then drawn from ``generator[j]`` in the order a
    one-instance draw takes, so the model equals M one-instance draws
    merged, bit for bit, and is written in place (no instance is ever
    held apart).  Each leaf is drawn one layer at a time and stored in
    its storage dtype at once, so no leaf is ever whole in f32:
    olmoe-1b-7b's expert weights at M = 4 are 51 GB in bf16 and would be
    twice that in f32.  ``cut`` (``shardings.moe_cut``) keeps a rank's
    slice of each drawn layer: the rank's shard, drawn with one layer of
    one leaf beside it at most."""
    dev, par = torch.device(device), torch_dtype(cfg.param_dtype)
    if isinstance(generator, (list, tuple)) and len(generator) != cfg.num_instances:
        raise ValueError(f"{len(generator)} generators for {cfg.num_instances} instances")
    m, d, v = cfg.num_instances, cfg.d_model, cfg.vocab_size

    def leaf(name, shape, init_, dtype, per_layer):
        return draw_leaf(name, shape, init_, dtype, per_layer, generator, dev, par, cut)

    tree = {
        "embed": leaf("embed", (m, v, d), "normal", par, False),
        "layers": {k: leaf(k, shape, init_, par if train else _leaf_dtype(cfg, k), True)
                   for k, (shape, init_) in _layer_shapes(cfg).items()},
        "final_norm": leaf("final_norm", (m, d), "ones", par, False),
        "lm_head": leaf("lm_head", (m, d, v), "fan_in", par, False),
    }
    return training_params(cfg, tree) if train else MergedParams(tree)


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
      or dropped (None without ``counts``);
    * ``probs`` (M, B, S, E): the f32 router softmax (the aux loss's)."""
    m, b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    # one product a row of the grid: the library picks its algorithm (and
    # whether to split the reduction) by the whole call's shape, so in one
    # batched product a row's f32 logits, and with them its routing
    # weights, would depend on how many rows share the call
    xf, rf = x.float().reshape(m, b * s, d), router.float()
    logits = torch.stack([xf[i] @ rf[i] for i in range(m)]).reshape(m, b, s, e)
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
            "w_sorted": w_sorted, "eid": eid, "pos": pos, "keep": keep, "counts": new_counts,
            "probs": probs}


def load_balance_aux(cfg: ModelConfig, r: dict) -> torch.Tensor:
    """The reference's Switch-style load-balance loss of one layer's
    routing ``r``: E * sum_e (frac_e / K) * mean p_e, averaged over the
    instances; frac_e counts the top-k assignments to expert e per token
    (no gradient), p_e is the f32 router softmax (0-d f32)."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    frac = F.one_hot(r["top_e"], e).float().sum(-2).mean(dim=(1, 2))      # (M, E)
    pmean = r["probs"].mean(dim=(1, 2))                                  # (M, E)
    return (e * (frac / k * pmean).sum(-1)).mean()


# ---------------------------------------------------------------------------
# the experts
# ---------------------------------------------------------------------------


def _expert_rows(cfg: ModelConfig, r: dict, m_w: int, inst, rank, reps: int, t: int,
                 lo: int = 0, e_l: int | None = None):
    """Where each sorted assignment's row lies in the (M_w * E_l * t + 1,
    D) block of expert inputs, for the window of E_l experts from ``lo``
    (all E on one device).  Pair p = (instance, window expert) owns rows
    [p * t, (p + 1) * t); a kept assignment in the window takes its
    pair's next row (the rows of one instance in (lane rank, batch row)
    order, then stream order), any other one the last row, which no
    product reads.  ``inst`` and ``rank`` (M,) are each row's instance and
    its rank among the rows of that instance; ``reps`` the most rows an
    instance has.  Returns (rows, local: kept and in the window)."""
    e_l = cfg.num_experts if e_l is None else e_l
    keep, eid, pos = r["keep"], r["eid"], r["pos"]
    local = keep & (eid >= lo) & (eid < lo + e_l)
    eid = (eid - lo).clamp(0, e_l - 1)
    m, b = keep.shape[:2]
    n_keep = torch.zeros(m, b, e_l, dtype=torch.long, device=keep.device)
    n_keep.scatter_add_(-1, eid, local.long())
    # the exclusive running count over the earlier rows of the same instance
    block = n_keep.new_zeros(m_w, reps * b, e_l)
    block.view(m_w, reps, b, e_l)[inst, rank] = n_keep
    before = (block.cumsum(1) - block).view(m_w, reps, b, e_l)[inst, rank]
    row = (inst.reshape(m, 1, 1) * e_l + eid) * t + before.gather(-1, eid) + pos
    return torch.where(local, row, torch.full_like(row, m_w * e_l * t)), local


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
            groups: L.LaneGroups | None = None, ltp=None, with_aux: bool = False):
    """x (M, B, S, D) -> (M, B, S, D) in x's dtype; with ``counts`` the
    chainable chunked form, returning (out, counts advanced); with
    ``with_aux`` (the whole-sequence form), (out, :func:`load_balance_aux`).

    ``lp`` holds this layer's ``router`` (M_w, D, E) and ``we_gate`` /
    ``we_up`` (M_w, E, D, F), ``we_down`` (M_w, E, F, D); with ``groups``
    row i of x reads instance ``groups.t[i]``.  ``valid`` (M, B, S) masks
    junk tokens out of routing; ``counts`` (M, B, E) int32 and ``limit``
    (M, B) int32 are the earlier chunks' assignments and the exact-length
    capacity of each row's request.

    ``ltp``, the expert group under an expert split, makes this the
    expert window of rank ``ltp.rank``: ``lp``'s ``we_*`` hold its E/T
    experts (M_w, E/T, ...), the routing is whole, and the ranks' partials
    are summed with ``ltp.all_reduce_sum``."""
    m, b, s, d = x.shape
    k = cfg.num_experts_per_tok
    chunked = counts is not None
    cap = s * k if chunked else capacity(cfg, s)
    router = lp["router"] if groups is None else groups.rows(lp["router"])
    r = route(cfg, router, x, cap=cap, valid=valid, counts=counts, limit=limit)

    wg, wu, wd = lp["we_gate"], lp["we_up"], lp["we_down"]
    m_w, e_l, ff = wg.shape[0], wg.shape[1], wg.shape[-1]
    lo = 0 if ltp is None else ltp.rank * e_l
    if groups is None:
        inst, rank, reps = torch.arange(m, device=x.device), x.new_zeros(m, dtype=torch.long), 1
    else:
        inst, rank, reps = groups.t, groups.r, groups.reps
    # a row holds at most min(S, cap) assignments of one expert (a token
    # picks an expert once): the rows of a pair, bounded from the shapes
    t = reps * b * min(s, cap)
    rows, local = _expert_rows(cfg, r, m_w, inst, rank, reps, t, lo, e_l)
    tok = r["order"] // k                                    # token of each assignment
    src = (torch.arange(m * b, device=x.device).reshape(m, b, 1) * s + tok).reshape(-1)
    n_rows = m_w * e_l * t
    xb = x.new_zeros(n_rows + 1, d)
    xb[rows.reshape(-1)] = x.reshape(m * b * s, d)[src]
    xe = xb[:-1].view(m_w * e_l, t, d)
    h = (F.silu(K.fused_matmul(xe, wg.reshape(m_w * e_l, d, ff)))
         * K.fused_matmul(xe, wu.reshape(m_w * e_l, d, ff)))
    ye = K.fused_matmul(h, wd.reshape(m_w * e_l, ff, d)).reshape(n_rows, d)
    y = ye[rows.clamp(max=n_rows - 1)]                       # (M, B, S*K, D)
    y = y * local[..., None].to(y.dtype)
    y = y * r["w_sorted"][..., None].to(y.dtype)
    out = S.sum_over(ltp, _combine(y, r, s, k))
    if chunked:
        return out, r["counts"]
    return (out, load_balance_aux(cfg, r)) if with_aux else out


def _experts_of(lay, i: int) -> dict:
    return {n: lay[n][i] for n in ("router", "we_gate", "we_up", "we_down")}


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def seq_layer(cfg: ModelConfig, lp, x, positions, cos, sin, *, window: int = 0):
    """One layer over a whole sequence x (M, B, S, D): dense's attention,
    then the experts at the capacity of the whole sequence.  Returns (x,
    k, v, the layer's aux)."""
    x, k, v = dense.seq_attention(cfg, lp, x, positions, cos, sin, window=window)
    y, aux = moe_mlp(cfg, lp, L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps), with_aux=True)
    return x + y, k, v, aux


def forward(cfg: ModelConfig, params, tokens, *, remat: bool = False,
            return_aux: bool = False):
    """Whole-sequence forward (training): logits (M, B, S, V) f32, and
    with ``return_aux`` the load-balance aux summed over the layers and
    divided by their count.  With ``remat`` each layer runs under
    activation checkpointing, (x, aux) its outputs."""
    x = dense._embed_in(cfg, params, tokens)
    positions = dense._positions(tokens)
    cos, sin = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta, x.dtype)

    def layer(xc, i):
        xc, _, _, a = seq_layer(cfg, dense._layer(params, i), xc, positions, cos, sin,
                                window=cfg.sliding_window)
        return xc, a

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        x, a = L.remat(layer, remat)(x, i)
        aux = aux + a
    logits = dense._logits(cfg, params, x)
    return (logits, aux / cfg.num_layers) if return_aux else logits


def prefill(cfg: ModelConfig, params, tokens, *, cache_len: int | None = None):
    """A whole prompt from scratch: (logits of the last position (M, B, V)
    f32, KVCache laid out as :func:`make_cache`'s), dense's shell
    (``dense.prefill_embeds``) with :func:`seq_layer`, routing at the
    capacity of the whole prompt.  Run it under ``torch.no_grad()`` (as
    ``api.prefill`` does): the experts then launch the kernel directly."""
    return dense.prefill_embeds(cfg, params, dense._embed_in(cfg, params, tokens),
                                dense._positions(tokens), cache_len=cache_len,
                                block=lambda *a, **kw: seq_layer(*a, **kw)[:3])


def make_cache(cfg: ModelConfig, m: int, b: int, context_len: int, device,
               tp=None) -> KVCache:
    """The grid's KV cache, (L, M, B, S, KVH, hd); a rank's shard holds
    its kv heads where the attention splits."""
    return dense.make_cache(cfg, m, b, context_len, device, tp)


def cache_axes(cfg: ModelConfig) -> KVCache:
    return dense.cache_axes(cfg)


def init_chunk_carry(cfg: ModelConfig, m: int, b: int, cache_len: int, device,
                     tp=None) -> dict:
    """The cache and, per layer (routers are independent per layer), the
    per-expert assignment counts of the earlier chunks: (L, M, B, E) on
    every rank, since every rank routes in full."""
    return {"cache": make_cache(cfg, m, b, cache_len, device, tp),
            "counts": torch.zeros(cfg.num_layers, m, b, cfg.num_experts, dtype=torch.int32,
                                  device=device)}


def chunk_carry_axes(cfg: ModelConfig) -> dict:
    return {"cache": cache_axes(cfg), "counts": ("layers", "instances", "batch", None)}


def prefill_chunk(cfg: ModelConfig, params, batch, carry, offset, *,
                  instances: list[int] | None = None, tp=None) -> dict:
    """One chunk of a state-carrying prefill with exact-length-equivalent
    routing.  batch["tokens"] (M, B, C) at positions offset .. offset + C
    - 1; batch["moe_limit"] (M, B) int32 the capacity an exact-length
    prefill of each request's real token count would use; batch["valid"]
    (M, B, C), when present, the real rows.  The cache and the counts
    are updated in place; ``instances`` maps row i to instance
    ``instances[i]``.  Under ``tp`` the chunk attention runs on the rank's
    heads and the experts on its window, each followed by a sum."""
    x = dense._embed_in(cfg, params, batch["tokens"], instances)
    valid, limit = batch.get("valid"), batch["moe_limit"]
    ctx = dense.chunk_context(cfg, params, x, carry["cache"], offset, valid, instances,
                              S.attn_group(cfg, tp))
    etp = S.expert_group(cfg, tp)
    lay, counts = params["layers"], carry["counts"]
    for i in range(cfg.num_layers):
        x, k, v = dense.chunk_attention(cfg, ctx, params, i, x)
        n = L.rms_norm(x, ctx.per_lane["mlp_norm"][i], cfg.norm_eps)
        y, new_counts = moe_mlp(cfg, _experts_of(lay, i), n, valid=valid, counts=counts[i],
                                limit=limit, groups=ctx.groups, ltp=etp)
        counts[i].copy_(new_counts)
        x = x + y
        dense.chunk_append(ctx, i, k, v)
    return carry


def _decode_layers(cfg: ModelConfig, params, cache: KVCache, x, pos, alive=None, tp=None):
    """The stack over x (M, B, D): the decode layer's attention phase on
    the rank's heads (ring append in place), the sum of the ranks'
    partials, its residual, then the MoE FFN on the rank's expert window
    (its own sum)."""
    lay = params["layers"]
    atp, etp = S.attn_group(cfg, tp), S.expert_group(cfg, tp)
    heads = cfg.num_heads // (1 if atp is None else atp.size)
    for i in range(cfg.num_layers):
        lp = {n: lay[n][i] for n in ATTN_LEAVES if n in lay}
        part, _, _ = K.decode_layer_attn(lp, x, cache.k[i], cache.v[i], pos, num_heads=heads,
                                         head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                                         window=cfg.sliding_window, eps=cfg.norm_eps,
                                         alive=alive)
        x = x + S.sum_over(atp, part)
        # a row's norm is its own reduction: the grid's rows per call vary
        # with the data split
        n = L.rms_norm_rowwise(x, lay["mlp_norm"][i], cfg.norm_eps)
        x = x + moe_mlp(cfg, _experts_of(lay, i), n[:, :, None], ltp=etp)[:, :, 0]
    return x


def decode_step(cfg: ModelConfig, params, cache: KVCache, tokens, pos, *, alive=None,
                tp=None):
    """One decode step.  tokens (M, B, 1); pos (M, B) int32.  Returns
    (logits (M, B, V) f32, cache updated in place); under a vocab split
    every rank gets the whole vocab's logits."""
    x = dense._embed_in(cfg, params, tokens)[:, :, 0]
    x = _decode_layers(cfg, params, cache, x, pos, alive, tp)
    n = L.rms_norm(x[:, :, None], params["final_norm"], cfg.norm_eps)
    logits = L.unembed(n, params["lm_head"])[:, :, 0]
    vtp = S.vocab_group(cfg, tp)
    return (logits if vtp is None else vtp.all_gather(logits, dim=-1)), cache


def decode_step_sample(cfg: ModelConfig, params, cache: KVCache, tokens, pos, *, alive=None,
                       tp=None):
    """Greedy decode step: (next token (M, B) int32, cache updated in
    place); final norm, logits and argmax in one fused kernel (per vocab
    slice under a vocab split, then the cross-rank combine)."""
    x = dense._embed_in(cfg, params, tokens)[:, :, 0]
    x = _decode_layers(cfg, params, cache, x, pos, alive, tp)
    return K.logits_sample_sharded(x, params["final_norm"], params["lm_head"],
                                   tp=S.vocab_group(cfg, tp), eps=cfg.norm_eps), cache
