"""Dense decode layer and fused greedy logits: plain PyTorch versions and
the launchers of their Hopper kernels (``csrc/decode_layer.cu``).

Port of ``repro/kernels/decode_layer.py`` (the Pallas ``_layer_kernel``,
phases "full" and "attn", ``_ffn_kernel`` and ``_logits_kernel``) with the
oracles of ``repro/kernels/ref.py`` (``decode_layer``, ``logits_sample``)
beside them.  The plain versions round where the reference's XLA path
rounds: weights in the activation dtype, f32 norm statistics, f32
scores, p cast to V's dtype before P·V, f32 logits.  ``kernels/ops.py``
picks one of the two by the device of the tensors, and holds the
tensor-parallel wrappers that sum the phases' partials across ranks.

The ring cache is updated in place (the reference aliases it in and
out).  ``alive`` (M, B) bool, when given, leaves the ring of every lane
where it is False untouched: the serving K-step block freezes a stopped
lane's cache that way.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def ring_attention_plain(q, ck, cv, pos, *, window: int = 0):
    """Single-token GQA attention over the ring after the append: q
    (M, B, H, hd), ck/cv (M, B, S, KVH, hd), pos (M, B).  Mirrors the
    reference's Sq=1 flash path (one KV block, f32 scores, p in V's
    dtype, f32 accumulation).  Returns (M, B, H, hd) in q's dtype."""
    kv_pos = L.cache_slot_positions(pos, ck.shape[2])
    return L.flash_attention_plain(q[:, :, None], ck, cv, pos[..., None], kv_pos,
                                   window=window)[:, :, 0]


def tp_head_plan(h: int, kvh: int, n_model: int) -> str | None:
    """The reference's tensor-parallel head-grouping recipe: q heads are
    laid out kvh-major, so a contiguous split of the H heads into
    ``n_model`` groups keeps every q head on the rank of its kv head.
    ``"kv"`` when the kv heads split evenly over the ranks, ``"expand"``
    when they do not, ``None`` when the q heads themselves cannot split."""
    if n_model <= 1 or h % n_model:
        return None
    return "kv" if kvh % n_model == 0 else "expand"


def decode_layer_attn_plain(lp, x, ck, cv, pos, *, num_heads, head_dim, rope_theta,
                            window: int = 0, eps: float = 1e-5, alive=None):
    """The attention half of a dense decode layer (the reference's
    ``_layer_kernel``, phase "attn"): rms -> QKV (+bias) -> RoPE -> ring
    append at pos % S -> attention -> out-proj, no residual.  x (M, B, D);
    ck/cv (M, B, S, KVH, hd) updated in place; pos (M, B).  Under tensor
    parallelism ``lp`` holds the rank's heads and the result is the
    rank's partial of the out-projection, rounded to x's dtype.  Returns
    (partial (M, B, D), ck, cv)."""
    m, b, d = x.shape
    s_cache, kvh = ck.shape[2], ck.shape[3]
    h, hd = num_heads, head_dim
    xs = x[:, :, None]
    n = L.rms_norm(xs, lp["attn_norm"], eps)
    q = L.linear(n, lp["wq"], lp.get("bq")).reshape(m, b, 1, h, hd)
    k = L.linear(n, lp["wk"], lp.get("bk")).reshape(m, b, 1, kvh, hd)
    v = L.linear(n, lp["wv"], lp.get("bv")).reshape(m, b, 1, kvh, hd)
    if rope_theta > 0:
        q = L.rope(q, pos[..., None], rope_theta)
        k = L.rope(k, pos[..., None], rope_theta)
    mi = torch.arange(m, device=x.device)[:, None]
    bi = torch.arange(b, device=x.device)[None, :]
    slot = (pos % s_cache).long()
    old_k, old_v = ck[mi, bi, slot], cv[mi, bi, slot]
    ck[mi, bi, slot] = k[:, :, 0].to(ck.dtype)
    cv[mi, bi, slot] = v[:, :, 0].to(cv.dtype)
    o = ring_attention_plain(q[:, :, 0], ck, cv, pos, window=window)
    if alive is not None:
        # a stopped lane's ring stays as it was (its output is discarded)
        keep = alive[..., None, None]
        ck[mi, bi, slot] = torch.where(keep, ck[mi, bi, slot], old_k)
        cv[mi, bi, slot] = torch.where(keep, cv[mi, bi, slot], old_v)
    return L.linear(o.reshape(m, b, h * hd), lp["wo"]), ck, cv


def ffn_plain(x, mlp_norm, w_gate, w_up, w_down, *, eps: float = 1e-5):
    """The FFN half (the reference's ``_ffn_kernel``): rms -> SwiGLU ->
    down-proj, no residual.  x (M, B, D); under tensor parallelism the
    weights hold the rank's slice of d_ff and the result is its partial."""
    n = L.rms_norm(x, mlp_norm, eps)
    return L.swiglu_mlp(n, w_gate, w_up, w_down)


def decode_layer_plain(lp, x, ck, cv, pos, *, num_heads, head_dim, rope_theta,
                       window: int = 0, eps: float = 1e-5, alive=None):
    """Unfused dense decode layer (``ref.decode_layer``): the attention
    half plus the residual, then the FFN half plus the residual.  x
    (M, B, D); ck/cv (M, B, S, KVH, hd) updated in place; pos (M, B).
    Returns (x_out, ck, cv)."""
    attn, ck, cv = decode_layer_attn_plain(lp, x, ck, cv, pos, num_heads=num_heads,
                                           head_dim=head_dim, rope_theta=rope_theta,
                                           window=window, eps=eps, alive=alive)
    x2 = x + attn
    return x2 + ffn_plain(x2, lp["mlp_norm"], lp["w_gate"], lp["w_up"], lp["w_down"],
                          eps=eps), ck, cv


def logits_argmax_plain(x, scale, head, *, eps: float = 1e-5):
    """Final rms + f32 logits + argmax: x (M, B, D), scale (M, D), head
    (M, D, V) -> (tok (M, B) int32, val (M, B) f32).  ``torch.argmax``
    returns the first maximal index, as ``jnp.argmax`` does."""
    n = L.rms_norm(x[:, :, None], scale, eps)
    logits = L.unembed(n, head)[:, :, 0]
    return logits.argmax(dim=-1).to(torch.int32), logits.amax(dim=-1)


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

_ATTN_SIG = "ippf" + "p" * 16 + "q" + "i" * 7 + "fiif" + "p"
_FFN_SIG = "ippf" + "p" * 7 + "q" + "iiii" + "p"


def _check_operands(dt, **tensors):
    for name, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {dt} here")


def _f32(t):
    return None if t is None else t.contiguous().float()


def _attn_phase(lp, x, ck, cv, pos, res, *, num_heads, head_dim, rope_theta, window, eps,
                alive):
    """``decode_layer_attn_phase`` of csrc/decode_layer.cu: out =
    res + out-proj when ``res`` is given, else the bare partial."""
    m, b, d = x.shape
    s_cache, kvh = ck.shape[2], ck.shape[3]
    h, hd = num_heads, head_dim
    dt = x.dtype
    bias = [lp.get(n) for n in ("bq", "bk", "bv")]
    _check_operands(dt, x=x, ck=ck, cv=cv, wq=lp["wq"], wk=lp["wk"], wv=lp["wv"],
                    wo=lp["wo"], bq=bias[0], bk=bias[1], bv=bias[2], res=res)
    if pos.dtype != torch.int32 or not pos.is_contiguous():
        raise TypeError("pos must be a contiguous int32 tensor")
    if alive is not None and (alive.dtype != torch.bool or not alive.is_contiguous()):
        raise TypeError("alive must be a contiguous bool tensor")
    if lp["wq"].shape[-1] != h * hd or lp["wk"].shape[-1] != kvh * hd:
        raise ValueError(f"wq/wk do not hold {h} / {kvh} heads of {hd}")
    n_part = build.entry("decode_layer", "decode_layer_attn_scratch_elems", "iiiiiii",
                         restype="q")(m, b, d, s_cache, h, kvh, hd)
    dev = x.device
    part = torch.empty((n_part,), dtype=torch.float32, device=dev)
    qkv = torch.empty((m, b, (h + 2 * kvh) * hd), dtype=dt, device=dev)
    attn = torch.empty((m, b, h * hd), dtype=dt, device=dev)
    out = torch.empty_like(x)
    P = build.ptr
    fn = build.entry("decode_layer", "decode_layer_attn_phase", _ATTN_SIG)
    neg_log_theta = -math.log(rope_theta) if rope_theta > 0 else 0.0
    build.check(fn(build.dtype_code(x), P(x), P(_f32(lp["attn_norm"])), eps, P(lp["wq"]),
                   P(lp["wk"]), P(lp["wv"]), *(P(t) for t in bias), P(lp["wo"]), P(ck), P(cv),
                   P(pos), P(alive), P(res), P(qkv), P(attn), P(out), P(part), n_part,
                   m, b, d, s_cache, h, kvh, hd, neg_log_theta, int(rope_theta > 0),
                   int(window), 1.0 / math.sqrt(hd), build.stream_ptr(x)),
                "decode_layer attention phase")
    return out


def _ffn_phase(x, mlp_norm, w_gate, w_up, w_down, res, *, eps):
    """``decode_layer_ffn_phase`` of csrc/decode_layer.cu: out =
    res + down-proj when ``res`` is given, else the bare partial."""
    m, b, d = x.shape
    ff = w_gate.shape[2]
    _check_operands(x.dtype, x=x, w_gate=w_gate, w_up=w_up, w_down=w_down, res=res)
    if w_up.shape[2] != ff or w_down.shape[1] != ff:
        raise ValueError("w_gate, w_up and w_down disagree on d_ff")
    n_part = build.entry("decode_layer", "decode_layer_ffn_scratch_elems", "iiii",
                         restype="q")(m, b, d, ff)
    part = torch.empty((n_part,), dtype=torch.float32, device=x.device)
    hid = torch.empty((m, b, ff), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    P = build.ptr
    fn = build.entry("decode_layer", "decode_layer_ffn_phase", _FFN_SIG)
    build.check(fn(build.dtype_code(x), P(x), P(_f32(mlp_norm)), eps, P(w_gate), P(w_up),
                   P(w_down), P(res), P(hid), P(out), P(part), n_part, m, b, d, ff,
                   build.stream_ptr(x)), "decode_layer FFN phase")
    return out


def decode_layer_attn_cuda(lp, x, ck, cv, pos, *, num_heads, head_dim, rope_theta,
                           window: int = 0, eps: float = 1e-5, alive=None):
    """The attention phase on the card: six launches (see the note in
    csrc/decode_layer.cu).  Same contract as :func:`decode_layer_attn_plain`."""
    part = _attn_phase(lp, x, ck, cv, pos, None, num_heads=num_heads, head_dim=head_dim,
                       rope_theta=rope_theta, window=window, eps=eps, alive=alive)
    return part, ck, cv


def ffn_cuda(x, mlp_norm, w_gate, w_up, w_down, *, eps: float = 1e-5):
    """The FFN phase on the card: four launches.  Same contract as
    :func:`ffn_plain`."""
    return _ffn_phase(x, mlp_norm, w_gate, w_up, w_down, None, eps=eps)


def decode_layer_cuda(lp, x, ck, cv, pos, *, num_heads, head_dim, rope_theta,
                      window: int = 0, eps: float = 1e-5, alive=None):
    """One dense decode layer for the whole (M, B) grid: the two phases,
    each adding its residual in its last epilogue (ten launches).  Same
    contract as :func:`decode_layer_plain`; the cache is appended in
    place."""
    x2 = _attn_phase(lp, x, ck, cv, pos, x, num_heads=num_heads, head_dim=head_dim,
                     rope_theta=rope_theta, window=window, eps=eps, alive=alive)
    out = _ffn_phase(x2, lp["mlp_norm"], lp["w_gate"], lp["w_up"], lp["w_down"], x2, eps=eps)
    return out, ck, cv


def logits_argmax_cuda(x, scale, head, *, eps: float = 1e-5):
    """Final rms + f32 logits + greedy argmax on the card: per-V-tile
    (max, first index), then an in-order strict-``>`` reduction.  Returns
    (tok (M, B) int32, val (M, B) f32)."""
    m, b, d = x.shape
    v = head.shape[2]
    for name, t in (("x", x), ("head", head)):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    ntiles = -(-v // 64)
    dev = x.device
    pval = torch.empty((m * b * ntiles,), dtype=torch.float32, device=dev)
    pidx = torch.empty((m * b * ntiles,), dtype=torch.int32, device=dev)
    tok = torch.empty((m, b), dtype=torch.int32, device=dev)
    val = torch.empty((m, b), dtype=torch.float32, device=dev)
    fn = build.entry("decode_layer", "logits_argmax", "iippfpppppiiiip")
    P = build.ptr
    sc = _f32(scale)
    build.check(fn(build.dtype_code(x), build.dtype_code(head), P(x), P(sc), eps,
                   P(head), P(pval), P(pidx), P(tok), P(val), m, b, d, v,
                   build.stream_ptr(x)), "logits_argmax")
    return tok, val
