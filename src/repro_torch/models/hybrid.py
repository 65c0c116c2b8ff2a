"""Hymba-style hybrid-head decoder -- hymba-1.5b (port of
``repro.models.hybrid``).

Every block runs an attention head-group and a Mamba (selective-SSM)
head-group in parallel on the same input; their outputs are normed per
branch and averaged.  Hymba's meta tokens -- ``NUM_META_TOKENS`` learned
embeddings at positions [0, R) -- are attention sinks every query sees,
also under the sliding window.  Layers {0, L/2, L-1} attend globally, the
others over a sliding window; decode groups contiguous layers by kind:
a plain ring over the whole context for the global groups, a ring of
``R + window`` slots whose first R slots pin the meta tokens for the SWA
groups.

Serving: ``prefill_chunk`` (chained chunks over the meta prefix and the
prompt), ``decode_step`` and ``decode_step_sample``.  Training and a
prefill from scratch: ``forward`` and ``prefill`` over the whole
sequence, as the reference's, its XLA attention in
``layers.flash_attention_plain`` (no kernel on either path).  Attention of a
prefill chunk is the chunk-attention kernel (``pin``/``window``/``sink``
per group); decode attention of every group is the decode-attention
kernel over the ring's first min(pos + 1, S) slots (an SWA ring holds
only keys inside the window; the reference serves those groups through
XLA).  Norms reduce each row on its own (``layers.rms_norm_rowwise``),
so a lane's decode does not depend on how many instances share the
call.  Greedy
decode ends in the fused logits kernel.  The Mamba branch is plain
PyTorch: the SSD chunk scan for a chunk, the one-step update for decode.

Tensor parallelism: with a ``TensorParallel`` handle ``tp`` the params
and caches are this rank's shard (``models/shardings.py`` decides the
attention heads, the FFN and the mamba branch apart).  A part that
splits ends in its row-split projection (``wo``, ``w_ssm_out``,
``w_down``), and the sum over the ranks follows it, before the branch's
norm: at most three sums per block.  Decode attention goes through
``decode_attention_sharded`` on the rank's heads, the prefill chunk
kernel runs on the rank's heads, and the logits stay whole on every
rank.

Caches and states are updated in place.  ``valid`` (M, B, C) marks the
junk suffix of a padded final chunk: its rows never reach a KV cache and
take gate-neutral Mamba steps.  ``alive`` (M, B) freezes a stopped decode
lane the same way: no ring write, Mamba h and conv kept.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.models import layers as L
from repro_torch.models import shardings as S
from repro_torch.models.common import (
    Factory, MergedParams, training_params, tree_put_slot, tree_take_slot,
)
from repro_torch.models.layers import KVCache
from repro_torch.models.ssm import _causal_conv, _lane_rows

NUM_META_TOKENS = 128
GLOBAL_WINDOW = 1 << 30  # "no window" sentinel for global-attention layers
DEFAULT_SWA = 1024
SSM_HEAD_DIM = 64

# batched matmul weights (``LaneGroups`` reads them through views)
MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_ssm_in", "w_bc", "w_dt", "w_ssm_out",
                 "w_gate", "w_up", "w_down")
# layer leaves the model casts to the activation dtype at every use, so
# they are stored in cfg.dtype; embed, meta tokens, lm_head, norm scales,
# a_log and b_dt stay in param_dtype
ACT_LEAVES = MATMUL_LEAVES + ("conv_w", "conv_b", "d_skip")


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# config helpers
# ---------------------------------------------------------------------------


def d_inner(cfg: ModelConfig) -> int:
    return 2 * cfg.d_model  # mamba expansion factor 2


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def ssm_heads(cfg: ModelConfig) -> int:
    di = d_inner(cfg)
    hd = SSM_HEAD_DIM
    while di % hd:
        hd //= 2
    return di // hd


def global_layers(cfg: ModelConfig) -> set[int]:
    n = cfg.num_layers
    return {0, n // 2, n - 1} if n >= 3 else set(range(n))


def swa_window(cfg: ModelConfig) -> int:
    return cfg.sliding_window if cfg.sliding_window else DEFAULT_SWA


def min_serving_context(cfg: ModelConfig, max_new: int = 0) -> int:
    """Smallest serving max_context: the SWA ring layout needs the meta
    tokens and a full window (plus decode headroom)."""
    return NUM_META_TOKENS + swa_window(cfg) + max_new


def decode_groups(cfg: ModelConfig) -> list[tuple[int, int, bool]]:
    """Contiguous (start, end, is_global) layer groups."""
    g = global_layers(cfg)
    groups, start = [], 0
    for i in range(1, cfg.num_layers + 1):
        if i == cfg.num_layers or (i in g) != (start in g):
            groups.append((start, i, start in g))
            start = i
    return groups


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def build_params(cfg: ModelConfig, f: Factory) -> dict:
    m, d, v = cfg.num_instances, cfg.d_model, cfg.vocab_size
    h, kvh, hd, ff = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    di, n, nh, L_ = d_inner(cfg), cfg.ssm_state, ssm_heads(cfg), cfg.num_layers
    layers = {
        "norm": f((L_, m, d), init="ones"),
        # attention branch
        "wq": f((L_, m, d, h * hd), init="fan_in"),
        "wk": f((L_, m, d, kvh * hd), init="fan_in"),
        "wv": f((L_, m, d, kvh * hd), init="fan_in"),
        "wo": f((L_, m, h * hd, d), init="fan_in"),
        "attn_out_norm": f((L_, m, d), init="ones"),
        # mamba branch (SSD form: dt and A per SSM head)
        "w_ssm_in": f((L_, m, d, 2 * di), init="fan_in"),
        "conv_w": f((L_, m, cfg.conv_kernel, di), init="fan_in"),
        "conv_b": f((L_, m, di), init="zeros"),
        "w_bc": f((L_, m, di, 2 * n), init="fan_in"),
        "w_dt": f((L_, m, di, nh), init="fan_in"),
        "b_dt": f((L_, m, nh), init="zeros"),
        "a_log": f((L_, m, nh), init="zeros"),
        "d_skip": f((L_, m, di), init="ones"),
        "w_ssm_out": f((L_, m, di, d), init="fan_in"),
        "ssm_out_norm": f((L_, m, d), init="ones"),
        # ffn
        "mlp_norm": f((L_, m, d), init="ones"),
        "w_gate": f((L_, m, d, ff), init="fan_in"),
        "w_up": f((L_, m, d, ff), init="fan_in"),
        "w_down": f((L_, m, ff, d), init="fan_in"),
    }
    return {
        "embed": f((m, v, d)),
        "meta_tokens": f((m, NUM_META_TOKENS, d)),
        "layers": layers,
        "final_norm": f((m, d), init="ones"),
        "lm_head": f((m, d, v), init="fan_in"),
    }


def storage_dtypes(cfg: ModelConfig, tree: dict) -> dict:
    """Cast a parameter tree to the port's storage dtypes."""
    act, par = torch_dtype(cfg.dtype), torch_dtype(cfg.param_dtype)
    out = {k: v.to(par) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: v.to(act if k in ACT_LEAVES else par)
                     for k, v in tree["layers"].items()}
    return out


def init(cfg: ModelConfig, generator: torch.Generator | None,
         device: torch.device, *, train: bool = False) -> MergedParams:
    """Random parameters with the reference's distributions, drawn from
    ``generator`` (on ``device``), in the port's storage dtypes; with
    ``train``, the trainable form (``common.training_params``)."""
    f = Factory(generator, torch_dtype(cfg.param_dtype), torch.device(device))
    tree = build_params(cfg, f)
    return training_params(cfg, tree) if train else MergedParams(storage_dtypes(cfg, tree))


# ---------------------------------------------------------------------------
# mamba branch
# ---------------------------------------------------------------------------


def _ssd_chunk_scan(u, da, b_in, c_out, h0, *, chunk: int = 64):
    """SSD chunkwise scan (exact; every exponent <= 0).

    u (M, B, S, H, hd) dt-scaled inputs; da (M, B, S, H) per-head log
    decay (<= 0); b_in, c_out (M, B, S, N); h0 (M, B, H, hd, N).  Returns
    (y (M, B, S, H, hd), h_final), f32.  Within a chunk the pairwise decay
    exp(cum_t - cum_s), s <= t, is a (Cs, Cs) matrix per head; chunks are
    linked by a loop carrying the (H, hd, N) state."""
    m, b, s, h, hd = u.shape
    n = b_in.shape[-1]
    cs = min(chunk, s)
    while s % cs:
        cs -= 1
    nc = s // cs

    uc = u.reshape(m, b, nc, cs, h, hd).float()
    dac = da.reshape(m, b, nc, cs, h)
    bc = b_in.reshape(m, b, nc, cs, n).float()
    cc = c_out.reshape(m, b, nc, cs, n).float()

    cum = torch.cumsum(dac, dim=3)                                  # (M,B,nc,Cs,H)
    diff = cum[:, :, :, :, None, :] - cum[:, :, :, None, :, :]      # (M,B,nc,t,s,H)
    tri = torch.tril(torch.ones(cs, cs, dtype=torch.bool, device=u.device))
    decay = torch.where(tri[None, None, None, :, :, None],
                        torch.exp(torch.clamp(diff, max=0.0)), torch.zeros((), device=u.device))
    gram = torch.einsum("mbctn,mbcsn->mbcts", cc, bc)               # (M,B,nc,t,s)
    y_intra = torch.einsum("mbctsh,mbcshd->mbcthd", decay * gram[..., None], uc)

    # chunk summaries, then the state carried across chunks
    decay_end = torch.exp(cum[:, :, :, -1, :])                      # (M,B,nc,H)
    w_end = torch.exp(cum[:, :, :, -1:, :] - cum)                   # (M,B,nc,Cs,H)
    chunk_in = torch.einsum("mbcsh,mbcshd,mbcsn->mbchdn", w_end, uc, bc)
    hst = h0.float()
    starts = []
    for ci in range(nc):
        starts.append(hst)                                          # state BEFORE chunk
        hst = decay_end[:, :, ci][..., None, None] * hst + chunk_in[:, :, ci]
    h_starts = torch.stack(starts, dim=2)                           # (M,B,nc,H,hd,N)
    y_inter = torch.exp(cum)[..., None] * torch.einsum("mbchdn,mbctn->mbcthd",
                                                       h_starts, cc)
    return (y_intra + y_inter).reshape(m, b, s, h, hd), hst


def mamba_branch(cfg: ModelConfig, lp, xn, *, state=None, valid=None, groups=None,
                 tp=None):
    """Selective SSM in SSD (head-shared decay) form.  xn (M, B, S, D);
    state {"h": (M, B, Di, N) f32, "conv": (M, B, K-1, Di)} or None (a
    zero state).  ``valid`` (M, B, S) bool: junk steps are gate-neutral
    (zero decay, zero input: h unchanged) and the conv window is taken at
    the last valid inputs, so the carried state equals the exact-length
    pass.  S == 1 with a state is the one-step decode update, S > 1 the
    chunk scan.  Returns (out (M, B, S, D), new state); the caller keeps
    the state.

    ``tp``, where the branch splits over its ranks: ``lp`` and the state
    hold this rank's SSM heads (``shardings``: ``w_ssm_in`` is the whole
    ``xi`` half and the rank's ``z`` half), the conv, B, C and dt are
    computed whole, and ``out`` is the rank's partial of
    ``w_ssm_out``."""
    m, b, s, d = xn.shape
    di, n = d_inner(cfg), cfg.ssm_state
    hd = di // ssm_heads(cfg)

    up = L.linear(xn, lp["w_ssm_in"], groups=groups)               # (M,B,S,Di+Di_l)
    xi, z = up[..., :di], up[..., di:]
    nh = z.shape[-1] // hd                                          # this rank's SSM heads
    h_lo = 0 if tp is None else tp.rank * nh
    heads, chans = slice(h_lo, h_lo + nh), slice(h_lo * hd, (h_lo + nh) * hd)
    conv_state = (state["conv"] if state is not None else
                  torch.zeros(m, b, cfg.conv_kernel - 1, di, dtype=xn.dtype,
                              device=xn.device))
    nvalid = valid.sum(-1) if valid is not None else None
    xc, new_conv = _causal_conv(xi, lp["conv_w"], lp["conv_b"], conv_state, nvalid)
    xc = F.silu(xc)

    bcp = L.linear(xc, lp["w_bc"], groups=groups).float()          # (M,B,S,2N)
    b_in, c_out = bcp[..., :n], bcp[..., n:]
    dt = F.softplus(L.linear(xc, lp["w_dt"], groups=groups).float()
                    + lp["b_dt"][:, None, None, :].float())[..., heads]   # (M,B,S,H)
    a = -torch.exp(lp["a_log"].float())[:, heads]                  # (M,H)
    da = dt * a[:, None, None, :]                                  # <= 0
    xc = xc[..., chans]
    u = dt[..., None] * xc.reshape(m, b, s, nh, hd).float()        # (M,B,S,H,hd)
    if valid is not None:
        da = torch.where(valid[..., None], da, torch.zeros_like(da))
        u = torch.where(valid[..., None, None], u, torch.zeros_like(u))

    if state is None or s > 1:
        h0 = (state["h"].reshape(m, b, nh, hd, n) if state is not None else
              torch.zeros(m, b, nh, hd, n, device=xn.device))
        y, h_fin = _ssd_chunk_scan(u, da, b_in, c_out, h0)
        y = y.reshape(m, b, s, nh * hd)
    else:
        h0 = state["h"].reshape(m, b, nh, hd, n)
        h_fin = (torch.exp(da[:, :, 0])[..., None, None] * h0
                 + u[:, :, 0][..., None] * b_in[:, :, 0][:, :, None, None, :])
        y = torch.einsum("mbhdn,mbn->mbhd", h_fin, c_out[:, :, 0]).reshape(m, b, 1, nh * hd)

    y = y.to(xn.dtype) + xc * lp["d_skip"][:, None, None, :].to(xn.dtype)
    out = L.linear(y * F.silu(z), lp["w_ssm_out"], groups=groups)
    return out, {"h": h_fin.reshape(m, b, nh * hd, n), "conv": new_conv}


# ---------------------------------------------------------------------------
# hybrid block
# ---------------------------------------------------------------------------


def hymba_layer(cfg: ModelConfig, lp, x, attend, ssm_state: dict | None, *,
                split: S.HybridSplit, valid=None, groups=None):
    """One hybrid block on x (M, B, S, D), nothing written in place.
    ``attend(xn)`` is the attention branch (projections, any cache write,
    attention, out-projection); ``ssm_state`` {"h", "conv"} the mamba
    state it starts from (None: zero).  ``split``
    (``shardings.hybrid_split``) names the parts that split over the
    ranks: each one's partial is summed before its norm.  Returns (x, the
    new mamba state)."""
    eps = cfg.norm_eps
    xn = L.rms_norm_rowwise(x, lp["norm"], eps)
    attn_out = S.sum_over(split.heads, attend(xn))
    ssm_out, new = mamba_branch(cfg, lp, xn, state=ssm_state, valid=valid, groups=groups,
                                tp=split.ssm)
    ssm_out = S.sum_over(split.ssm, ssm_out)
    fused = 0.5 * (L.rms_norm_rowwise(attn_out, lp["attn_out_norm"], eps)
                   + L.rms_norm_rowwise(ssm_out, lp["ssm_out_norm"], eps))
    x = x + fused
    nrm = L.rms_norm_rowwise(x, lp["mlp_norm"], eps)
    return x + S.sum_over(split.ffn, L.swiglu_mlp(nrm, lp["w_gate"], lp["w_up"],
                                                  lp["w_down"], groups)), new


def hymba_block(cfg: ModelConfig, lp, x, attend, ssm_state: dict, *, split: S.HybridSplit,
                valid=None, groups=None):
    """:func:`hymba_layer` with ``ssm_state`` updated in place (serving);
    returns x."""
    x, new = hymba_layer(cfg, lp, x, attend, ssm_state, split=split, valid=valid,
                         groups=groups)
    ssm_state["h"].copy_(new["h"])
    ssm_state["conv"].copy_(new["conv"])
    return x


def _qkv(cfg, lp, xn, cos, sin, groups=None):
    """q, k, v of the heads ``lp`` holds (a rank's share under a split)."""
    m, b, s, _ = xn.shape
    hd = cfg.head_dim
    h, kvh = lp["wq"].shape[-1] // hd, lp["wk"].shape[-1] // hd
    q = L.linear(xn, lp["wq"], groups=groups).reshape(m, b, s, h, hd)
    k = L.linear(xn, lp["wk"], groups=groups).reshape(m, b, s, kvh, hd)
    v = L.linear(xn, lp["wv"], groups=groups).reshape(m, b, s, kvh, hd)
    return L.rope_apply(q, cos, sin), L.rope_apply(k, cos, sin), v


def _layer(params, i: int) -> dict:
    lay = params["layers"]
    return {k: lay[k][i] for k in lay.keys()}


def _ssm_layer(cache, i: int) -> dict:
    return {k: v[i] for k, v in cache["ssm"].items()}


def _kv_for_q(split: S.HybridSplit, device):
    """Where a rank's q heads straddle kv groups unevenly, the function
    that repeats k, v (..., KVH_l, hd) to one head per q head (the
    reference's repeat form, a copy); else the identity."""
    if split.kv_index is None:
        return lambda t: t
    idx = torch.tensor(split.kv_index, device=device)
    return lambda t: t.index_select(-2, idx)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def make_cache(cfg: ModelConfig, m: int, b: int, context_len: int, device,
               tp=None) -> dict:
    """Per decode group a KV cache (meta + SWA ring for SWA groups, the
    whole context for global groups) and per layer the mamba state; a
    rank's shard holds the kv heads its q heads read and the state of
    its SSM heads (the conv window stays whole)."""
    w = swa_window(cfg)
    act = torch_dtype(cfg.dtype)
    sp = S.hybrid_split(cfg, tp)
    kv = []
    for (i0, i1, is_global) in decode_groups(cfg):
        s_cache = context_len if is_global else min(NUM_META_TOKENS + w, context_len)
        kv.append(L.make_kv_cache(i1 - i0, m, b, s_cache, sp.kv_hi - sp.kv_lo,
                                  cfg.head_dim, act, device))
    di, nl = d_inner(cfg), cfg.num_layers
    di_l = di if sp.ssm is None else di // sp.ssm.size
    ssm = {"h": torch.zeros(nl, m, b, di_l, cfg.ssm_state, device=device),
           "conv": torch.zeros(nl, m, b, cfg.conv_kernel - 1, di, dtype=act, device=device)}
    return {"kv": kv, "ssm": ssm}


def init_chunk_carry(cfg: ModelConfig, m: int, b: int, cache_len: int, device,
                     tp=None) -> dict:
    return {"cache": make_cache(cfg, m, b, cache_len, device, tp)}


def cache_axes(cfg: ModelConfig) -> dict:
    """Logical axes of the cache tree."""
    ax = ("layers", "instances", "batch", "cache_seq", "kv_heads", "kv_hd")
    return {
        "kv": [KVCache(k=ax, v=ax) for _ in decode_groups(cfg)],
        "ssm": {"h": ("layers", "instances", "batch", "mlp", None),
                "conv": ("layers", "instances", "batch", None, "mlp")},
    }


def chunk_carry_axes(cfg: ModelConfig) -> dict:
    return {"cache": cache_axes(cfg)}


def take_state(cfg: ModelConfig, cache, m: int, b: int):
    """Slot (m, b) of the grid cache (views, singleton dims kept).  The
    SWA rings and global caches keep their layouts, so the slot drops
    back in with put_state without re-rotation."""
    return tree_take_slot(cache, cache_axes(cfg), m, b)


def put_state(cfg: ModelConfig, grid, one, m: int, b: int):
    """Write a single-slot cache into grid slot (m, b), in place; a KV
    leaf with another context length is prefix-clipped."""
    return tree_put_slot(grid, cache_axes(cfg), one, m, b)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def prefill_chunk(cfg: ModelConfig, params, batch, carry, offset, *,
                  instances: list[int] | None = None, tp=None) -> dict:
    """One chunk of a state-carrying prefill.  Positions [0, R) are the
    meta tokens (embeddings from ``params["meta_tokens"]``; the chunk's
    token ids there are ignored), prompt tokens follow at R + i.  Per
    decode group, the chunk attends over [group cache before the chunk,
    chunk] through the chunk-attention kernel with the group's ``pin``,
    ``window`` and the meta ``sink``, then appends its k/v in place;
    mamba states thread through ``mamba_branch``.  ``instances`` maps row
    i of the batch to row ``instances[i]`` of the merged model.  Under
    ``tp`` the chunk kernel runs on the rank's q and kv heads."""
    tokens, valid = batch["tokens"], batch.get("valid")
    cache = carry["cache"]
    m, b, c = tokens.shape
    r = NUM_META_TOKENS
    act = torch_dtype(cfg.dtype)
    positions = offset[..., None] + torch.arange(c, dtype=offset.dtype, device=offset.device)
    tok_x = L.embed(tokens, params["embed"], act, instances)
    meta = params["meta_tokens"]
    groups = None
    if instances is not None:
        groups = L.LaneGroups(instances, params["final_norm"].shape[0], tok_x.device)
        meta = groups.rows(meta, 0)
    midx = torch.clamp(positions, 0, r - 1).long()
    lane = torch.arange(m, device=tok_x.device)[:, None, None]
    meta_x = meta[lane, midx].to(act)                               # (M,B,C,D)
    x = torch.where((positions < r)[..., None], meta_x, tok_x)
    cos, sin = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta, act)
    w = swa_window(cfg)
    split = S.hybrid_split(cfg, tp)
    per_q = _kv_for_q(split, x.device)

    for gi, (i0, i1, is_global) in enumerate(decode_groups(cfg)):
        kv = cache["kv"][gi]
        s_cache = kv.k.shape[3]
        pin = 0 if is_global else r
        win = GLOBAL_WINDOW if is_global else w
        index = L.chunk_write_index(positions, s_cache, pin, valid)
        for li in range(i0, i1):
            lp = _lane_rows(_layer(params, li), groups, MATMUL_LEAVES)
            ck, cv = kv.k[li - i0], kv.v[li - i0]

            def attend(xn, lp=lp, ck=ck, cv=cv, s_cache=s_cache, pin=pin, win=win,
                       index=index):
                q, k, v = _qkv(cfg, lp, xn, cos, sin, groups)
                k_all = torch.cat([ck, k.to(ck.dtype)], dim=2)
                v_all = torch.cat([cv, v.to(cv.dtype)], dim=2)
                o = K.chunk_prefill_attention(q, per_q(k_all), per_q(v_all), offset,
                                              s_cache=s_cache, pin=pin, window=win, sink=r)
                L.cache_append_chunk(ck, k, positions, index=index)
                L.cache_append_chunk(cv, v, positions, index=index)
                return L.linear(o.reshape(m, b, c, -1), lp["wo"], groups=groups)

            x = hymba_block(cfg, lp, x, attend, _ssm_layer(cache, li), valid=valid,
                            groups=groups, split=split)
    return carry


def _decode_trunk(cfg: ModelConfig, params, cache, tokens, pos, alive=None, tp=None):
    """Every block over one token per lane; tokens (M, B, 1), pos (M, B)
    the absolute position including the meta offset.  Every layer's
    attention is ``decode_attention_sharded`` under ``tp`` (the rank's
    block, every plan), ``decode_attention`` on one device: in both
    layouts the visible keys are exactly slots [0, min(pos + 1, S)), the
    kernel's contract -- a global group's plain ring has no effective
    window, and an SWA group's ring of S - R <= window slots after the R
    pinned meta slots holds only keys inside the window."""
    m, b, _ = tokens.shape
    r = NUM_META_TOKENS
    act = torch_dtype(cfg.dtype)
    x = L.embed(tokens, params["embed"], act)
    positions = pos[..., None]
    cos, sin = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta, act)
    valid = alive[..., None] if alive is not None else None
    split = S.hybrid_split(cfg, tp)

    for gi, (i0, i1, is_global) in enumerate(decode_groups(cfg)):
        kv = cache["kv"][gi]
        s_cache = kv.k.shape[3]
        slot = pos % s_cache if is_global else r + (pos - r) % (s_cache - r)
        kv_len = torch.clamp(pos + 1, max=s_cache)
        for li in range(i0, i1):
            lp = _layer(params, li)
            ck, cv = kv.k[li - i0], kv.v[li - i0]

            def attend(xn, lp=lp, ck=ck, cv=cv):
                q, k, v = _qkv(cfg, lp, xn, cos, sin)
                L.cache_update_one(ck, k, slot, alive)
                L.cache_update_one(cv, v, slot, alive)
                o = K.decode_attention_sharded(q[:, :, 0], ck, cv, kv_len, plan=split.plan,
                                               tp=tp, num_kv_heads=cfg.num_kv_heads)
                return L.linear(o.reshape(m, b, 1, -1), lp["wo"])

            x = hymba_block(cfg, lp, x, attend, _ssm_layer(cache, li), valid=valid,
                            split=split)
    return x


def decode_step(cfg: ModelConfig, params, cache, tokens, pos, *, alive=None, tp=None):
    """tokens (M, B, 1); pos (M, B) absolute position including the meta
    offset (the first generated token decodes at pos = R + len(prompt) - 1
    with the last prompt token).  Returns (logits (M, B, V) f32, cache
    updated in place); under ``tp`` every rank computes the whole."""
    x = _decode_trunk(cfg, params, cache, tokens, pos, alive, tp)
    n = L.rms_norm_rowwise(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(n, params["lm_head"])[:, :, 0], cache


def decode_step_sample(cfg: ModelConfig, params, cache, tokens, pos, *, alive=None,
                       tp=None):
    """Greedy decode step: (next token (M, B) int32, cache updated in
    place).  Final norm, logits and argmax are the fused logits kernel,
    over the whole vocab on every rank (V is odd: it never splits)."""
    x = _decode_trunk(cfg, params, cache, tokens, pos, alive, tp)
    tok = K.logits_sample_sharded(x[:, :, 0], params["final_norm"], params["lm_head"],
                                  tp=None, eps=cfg.norm_eps)
    return tok, cache


# ---------------------------------------------------------------------------
# whole-sequence entry points (training, a prefill from scratch)
# ---------------------------------------------------------------------------


def _seq_in(cfg: ModelConfig, params, tokens):
    """The meta tokens then the prompt's embeddings, (M, B, R + S, D), with
    their positions 0 .. R + S - 1 and RoPE tables."""
    m, b, s = tokens.shape
    act = torch_dtype(cfg.dtype)
    x = L.embed(tokens, params["embed"], act)
    meta = params["meta_tokens"][:, None].to(act).expand(m, b, NUM_META_TOKENS, x.shape[-1])
    x = torch.cat([meta, x], dim=2)
    positions = torch.arange(x.shape[2], dtype=torch.int32, device=x.device).expand(
        m, b, x.shape[2])
    cos, sin = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta, act)
    return x, positions, cos, sin


def _seq_attend(cfg: ModelConfig, lp, positions, cos, sin, window: int, kv=None):
    """The attention branch over a whole sequence: causal, the layer's
    window with the meta tokens as sinks (``layers.flash_attention_plain``,
    the reference's XLA ``flash_attention``; no kernel).  Appends the
    rotated k, v to ``kv`` when given."""
    def attend(xn):
        m, b, s, _ = xn.shape
        q, k, v = _qkv(cfg, lp, xn, cos, sin)
        if kv is not None:
            kv.extend((k, v))
        o = L.flash_attention_plain(q, k, v, positions, positions, window=window,
                                    sink=NUM_META_TOKENS)
        return L.linear(o.reshape(m, b, s, -1), lp["wo"])
    return attend


def _window(cfg: ModelConfig, i: int) -> int:
    return GLOBAL_WINDOW if i in global_layers(cfg) else swa_window(cfg)


def forward(cfg: ModelConfig, params, tokens, *, remat: bool = False):
    """Whole-sequence forward (training): logits (M, B, S, V) f32 over the
    prompt's positions (the meta tokens' are dropped).  With ``remat``
    each layer runs under activation checkpointing."""
    x, positions, cos, sin = _seq_in(cfg, params, tokens)
    split = S.hybrid_split(cfg, None)
    for i in range(cfg.num_layers):
        def layer(xc, i=i):
            lp = _layer(params, i)
            attend = _seq_attend(cfg, lp, positions, cos, sin, _window(cfg, i))
            return hymba_layer(cfg, lp, xc, attend, None, split=split)[0]
        x = L.remat(layer, remat)(x)
    n = L.rms_norm_rowwise(x[:, :, NUM_META_TOKENS:], params["final_norm"], cfg.norm_eps)
    return L.unembed(n, params["lm_head"])


def prefill(cfg: ModelConfig, params, tokens):
    """A whole prompt from scratch: (logits of the last position (M, B, V)
    f32, the decode cache).  Layer by layer, each layer's k, v go into its
    group's cache: a global group's holds positions 0 .. R + S - 1 from
    slot 0; an SWA group's pins the R meta tokens and keeps the prompt's
    last ring-width positions at their ring slots.  The cache's context is
    max(R + S, R + window), so decode continues at pos = R + S."""
    m, b, s = tokens.shape
    r, w = NUM_META_TOKENS, swa_window(cfg)
    x, positions, cos, sin = _seq_in(cfg, params, tokens)
    st = x.shape[2]
    cache = make_cache(cfg, m, b, max(st, r + w), x.device)
    split = S.hybrid_split(cfg, None)
    for gi, (i0, i1, is_global) in enumerate(decode_groups(cfg)):
        ck_g, cv_g = cache["kv"][gi]
        for li in range(i0, i1):
            lp = _layer(params, li)
            kv = []
            x, new = hymba_layer(cfg, lp, x, _seq_attend(cfg, lp, positions, cos, sin,
                                                         _window(cfg, li), kv),
                                 None, split=split)
            cache["ssm"]["h"][li] = new["h"]
            cache["ssm"]["conv"][li] = new["conv"]
            for dst, t in zip((ck_g[li - i0], cv_g[li - i0]), kv):
                if is_global:
                    dst[:, :, :st] = t
                    continue
                ring = dst.shape[2] - r
                dst[:, :, :r] = t[:, :, :r]
                if st - r <= ring:
                    dst[:, :, r:st] = t[:, :, r:]
                else:
                    # the last ``ring`` positions, rotated to their ring slots
                    dst[:, :, r:] = torch.roll(t[:, :, st - ring:], (st - r) % ring, dims=2)
    n = L.rms_norm_rowwise(x[:, :, -1:], params["final_norm"], cfg.norm_eps)
    return L.unembed(n, params["lm_head"])[:, :, 0], cache
