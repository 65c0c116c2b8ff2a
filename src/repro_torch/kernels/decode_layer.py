"""Dense decode layer and fused greedy logits: plain PyTorch versions and
the launchers of their Hopper kernels (``csrc/decode_layer.cu``).

Port of ``repro/kernels/decode_layer.py`` (the Pallas ``_layer_kernel``,
phase "full", and ``_logits_kernel``) with the oracles of
``repro/kernels/ref.py`` (``decode_layer``, ``logits_sample``) beside
them.  The plain versions round where the reference's XLA path rounds:
weights in the activation dtype, f32 norm statistics, f32 scores, p cast
to V's dtype before P·V, f32 logits.  ``kernels/ops.py`` picks one of the
two by the device of the tensors.

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


def decode_layer_plain(lp, x, ck, cv, pos, *, num_heads, head_dim, rope_theta,
                       window: int = 0, eps: float = 1e-5, alive=None):
    """Unfused dense decode layer (``ref.decode_layer``): rms -> QKV
    (+bias) -> RoPE -> ring append at pos % S -> attention -> out-proj ->
    residual -> rms -> SwiGLU -> residual.  x (M, B, D); ck/cv
    (M, B, S, KVH, hd) updated in place; pos (M, B).  Returns
    (x_out, ck, cv)."""
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
    xs = xs + L.linear(o.reshape(m, b, 1, h * hd), lp["wo"])
    n = L.rms_norm(xs, lp["mlp_norm"], eps)
    xs = xs + L.swiglu_mlp(n, lp["w_gate"], lp["w_up"], lp["w_down"])
    return xs[:, :, 0], ck, cv


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

_MATVEC_SIG = "iippf" + "p" * 6 + "iii" + "ppp" + "i" + "iii" + "p"


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


def decode_layer_cuda(lp, x, ck, cv, pos, *, num_heads, head_dim, rope_theta,
                      window: int = 0, eps: float = 1e-5, alive=None):
    """One dense decode layer for the whole (M, B) grid in ten kernel
    launches (see the note in csrc/decode_layer.cu).  Same contract as
    :func:`decode_layer_plain`; the cache is appended in place."""
    m, b, d = x.shape
    s_cache, kvh = ck.shape[2], ck.shape[3]
    h, hd = num_heads, head_dim
    ff = lp["w_gate"].shape[2]
    dt = x.dtype
    code = build.dtype_code(x)
    bias = [lp.get(n) for n in ("bq", "bk", "bv")]
    _check_operands(dt, x=x, ck=ck, cv=cv, wq=lp["wq"], wk=lp["wk"], wv=lp["wv"],
                    wo=lp["wo"], w_gate=lp["w_gate"], w_up=lp["w_up"],
                    w_down=lp["w_down"], bq=bias[0], bk=bias[1], bv=bias[2])
    if pos.dtype != torch.int32 or not pos.is_contiguous():
        raise TypeError("pos must be a contiguous int32 tensor")
    if alive is not None and (alive.dtype != torch.bool or not alive.is_contiguous()):
        raise TypeError("alive must be a contiguous bool tensor")
    an, mn = _f32(lp["attn_norm"]), _f32(lp["mlp_norm"])
    st = build.stream_ptr(x)
    P = build.ptr
    mv = build.entry("decode_layer", "lanes_matvec", _MATVEC_SIG)
    attn_fn = build.entry("decode_layer", "ring_attention", "i" + "p" * 7 + "q" + "iiiiii"
                          + "fiifp")
    attn_scratch = build.entry("decode_layer", "ring_attention_scratch_elems", "iiiiii",
                               restype="q")

    scratch = build.entry("decode_layer", "matvec_scratch_elems", "iiiiiii")

    def matvec(mode, inp, norm, w0, w1, w2, biases, ns, res, out, k):
        n_part = scratch(mode, *ns, m, b, k)
        part = torch.empty((n_part,), dtype=torch.float32, device=x.device)
        build.check(mv(code, mode, P(inp), P(norm), eps, P(w0), P(w1), P(w2),
                       *(P(t) for t in biases), *ns, P(res), P(out), P(part), n_part,
                       m, b, k, st), f"decode_layer matvec mode {mode}")

    nqkv = (h + 2 * kvh) * hd
    qkv = torch.empty((m, b, nqkv), dtype=dt, device=x.device)
    matvec(0, x, an, lp["wq"], lp["wk"], lp["wv"], bias, (h * hd, kvh * hd, kvh * hd),
           None, qkv, d)
    attn = torch.empty((m, b, h * hd), dtype=dt, device=x.device)
    neg_log_theta = -math.log(rope_theta) if rope_theta > 0 else 0.0
    n_part = attn_scratch(m, b, s_cache, h, kvh, hd)
    part = torch.empty((n_part,), dtype=torch.float32, device=x.device)
    build.check(attn_fn(code, P(qkv), P(ck), P(cv), P(pos), P(alive), P(attn), P(part),
                        n_part, m, b, s_cache, h, kvh, hd, neg_log_theta, int(rope_theta > 0),
                        int(window), 1.0 / math.sqrt(hd), st), "decode_layer attention")
    none3 = (None, None, None)
    x2 = torch.empty_like(x)
    matvec(1, attn, None, lp["wo"], None, None, none3, (d, 0, 0), x, x2, h * hd)
    hid = torch.empty((m, b, ff), dtype=dt, device=x.device)
    matvec(2, x2, mn, lp["w_gate"], lp["w_up"], None, none3, (ff, 0, 0), None, hid, d)
    out = torch.empty_like(x)
    matvec(1, hid, None, lp["w_down"], None, None, none3, (d, 0, 0), x2, out, ff)
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
