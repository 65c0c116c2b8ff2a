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

In bf16 the layer's products run on the wgmma path, over groups of at
most 16 lanes of an instance (:func:`matvec_plan` says how each is split
and grouped); f32 keeps the lanes matvec of CUDA cores.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

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
# launch plans of the wgmma path
# ---------------------------------------------------------------------------

# csrc/decode_layer.cu's wgmma matvec: output columns per block, k per
# stage, most blocks of a split cluster, fewest k-steps a split keeps, the
# ring's bytes (plain: 6 stages of one weight's 16 KB tile; gate/up: 4 of
# both weights' 32 KB), largest dynamic shared memory
TC_TILE, TC_HK, TC_MAX_SPLIT, TC_MIN_SPLIT_STEPS = 128, 64, 8, 4
TC_RING = {False: 6 * 16384 + 16 * 6, True: 4 * 32768 + 16 * 4}
MAX_SMEM = 232448
# the split targets half of the nominal grid's SMs at its instances
# (``build.NOMINAL_*``)
SPLIT_TARGET_BLOCKS = build.NOMINAL_SMS // 2


@dataclass(frozen=True)
class MatvecPlan:
    """One product x (m, b, k) @ w (m, k, n): the variant ("tc", the
    wgmma kernel, or "simt", the lanes matvec), the lanes' wgmma N (8 or
    16), the output tile, the split of k's steps over a cluster, the grid
    (column tiles, split, m x lane groups), the shared memory of a block
    and the lane groups of an instance (of at most 16 lanes each)."""
    variant: str
    rows: int
    tile: int
    split: int
    grid: tuple[int, int, int]
    smem: int
    groups: int = 1


def tc_smem(n_rows: int, nk: int, pair: bool = False) -> int:
    """csrc/decode_layer.cu's ``tc_smem``: ring, the lanes' x^T over nk
    k-steps, the norm statistics."""
    return 1024 + -(-TC_RING[pair] // 1024) * 1024 + nk * n_rows * 128 + 64


def tc_split(k: int, n, pair: bool = False) -> int:
    """The split of a wgmma product's k-steps over a cluster, from the
    weight's shape alone: the k-steps split (at most 8 ways, each keeping
    at least 4 steps) until ``build.NOMINAL_INSTANCES`` instances' blocks would
    fill ``SPLIT_TARGET_BLOCKS``, then further until 16 lanes' x^T for a
    block's k range fits in shared memory.  So a lane's output is the
    same bits at any instance count and any lane count up to 16 (the
    wgmma N of 8 and of 16 take one split)."""
    segs = (n,) if isinstance(n, int) else tuple(n)
    tiles = sum(-(-w // TC_TILE) for w in segs)
    steps = -(-k // TC_HK)
    split = 1
    while (split < min(TC_MAX_SPLIT, steps // TC_MIN_SPLIT_STEPS)
           and tiles * build.NOMINAL_INSTANCES * split < SPLIT_TARGET_BLOCKS):
        split += 1
    while tc_smem(16, -(-steps // split), pair) > MAX_SMEM and split < min(TC_MAX_SPLIT, steps):
        split += 1
    return split


def matvec_plan(m: int, b: int, k: int, n, dtype: str = "bfloat16",
                pair: bool = False) -> MatvecPlan:
    """The launch of one decode-layer product: x (m, b, k) @ w (m, k, n),
    ``n`` an int or the widths of the segments the grid's tiles walk (QKV:
    q, k, v); ``pair``: two weights per tile (gate and up).

    bf16 with 16-byte rows takes the wgmma kernel: an instance's lanes
    split into groups of 16 (the last one holds the rest), a group's
    lanes are the wgmma N (8 up to 8 lanes in all, else 16), each block
    owns 128 output columns of one group, and :func:`tc_split` splits the
    k-steps over a cluster of blocks.  N 8 and N 16 share one split, so a
    lane's output is the same bits at any lane count.  Anything else
    keeps the lanes matvec (``variant == "simt"``), which sums in another
    order."""
    segs = (n,) if isinstance(n, int) else tuple(n)
    tiles = sum(-(-w // TC_TILE) for w in segs)
    simt = MatvecPlan("simt", b, 256, 1, (tiles, 1, m), 0)
    if dtype != "bfloat16" or k % 8 or any(w % 8 for w in segs):
        return simt
    rows, groups = (8 if b <= 8 else 16), -(-b // 16)
    steps = -(-k // TC_HK)
    split = tc_split(k, segs, pair)
    smem = tc_smem(rows, -(-steps // split), pair)
    if smem > MAX_SMEM:
        return simt
    return MatvecPlan("tc", rows, TC_TILE, split, (tiles, split, m * groups), smem, groups)


@functools.lru_cache(maxsize=256)
def attn_plans(m: int, b: int, d: int, h: int, kvh: int, hd: int,
               dtype: str = "bfloat16") -> dict[str, MatvecPlan] | None:
    """The plans of the attention phase's products, QKV and out (a rank's
    share of the heads under tensor parallelism), or None where either
    keeps the lanes matvec: then the whole phase does."""
    plans = {"qkv": matvec_plan(m, b, d, (h * hd, kvh * hd, kvh * hd), dtype),
             "out": matvec_plan(m, b, h * hd, d, dtype)}
    return plans if all(p.variant == "tc" for p in plans.values()) else None


@functools.lru_cache(maxsize=256)
def ffn_plans(m: int, b: int, d: int, ff: int,
              dtype: str = "bfloat16") -> dict[str, MatvecPlan] | None:
    """The plans of the FFN phase's products, gate/up and down, or None
    where either keeps the lanes matvec."""
    plans = {"gate_up": matvec_plan(m, b, d, ff, dtype, pair=True),
             "down": matvec_plan(m, b, ff, d, dtype)}
    return plans if all(p.variant == "tc" for p in plans.values()) else None


@functools.lru_cache(maxsize=256)
def layer_plans(m: int, b: int, d: int, h: int, kvh: int, hd: int, ff: int,
                dtype: str = "bfloat16") -> dict[str, MatvecPlan] | None:
    """The plans of a whole layer's four products, or None where any of
    them keeps the lanes matvec: then the whole layer does."""
    a, f = attn_plans(m, b, d, h, kvh, hd, dtype), ffn_plans(m, b, d, ff, dtype)
    return None if a is None or f is None else {**a, **f}


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


_ATTN_TC_SIG = "ppf" + "p" * 16 + "q" + "i" * 7 + "fiif" + "iip"
_FFN_TC_SIG = "ppf" + "p" * 6 + "iiii" + "iip"
_LAYER_TC_SIG = "pppf" + "p" * 20 + "q" + "i" * 8 + "fiif" + "iiiip"

# scratch of the wgmma path, kept per (device, stream, shapes): the layer's
# intermediates never leave the wrapper, and a decode step reuses them
_scratch: dict[tuple, dict] = {}


def _tc_scratch(x, s_cache, h, kvh, hd, ff):
    m, b, d = x.shape
    dev = x.device
    key = (str(dev), build.stream_ptr(x), m, b, d, s_cache, h, kvh, hd, ff, x.dtype)
    sc = _scratch.get(key)
    if sc is None:
        if len(_scratch) >= 64:
            _scratch.clear()
        n_part = build.entry("decode_layer", "decode_layer_attn_scratch_elems", "iiiiiii",
                             restype="q")(m, b, d, s_cache, h, kvh, hd) if h else 0
        sc = _scratch[key] = {
            "n_part": n_part,
            "part": torch.empty((n_part,), dtype=torch.float32, device=dev),
            "qkv": torch.empty((m, b, (h + 2 * kvh) * hd), dtype=x.dtype, device=dev),
            "attn": torch.empty((m, b, h * hd), dtype=x.dtype, device=dev),
            "x2": torch.empty_like(x),
            "hid": torch.empty((m, b, max(ff, 1)), dtype=x.dtype, device=dev)}
    return sc


def _map(w) -> int:
    """Host address of weight ``w``'s tensor map (boxes of 64 x 64, the
    128-byte swizzle), encoded once."""
    if w.data_ptr() % 16:
        raise ValueError("a weight must be 16-byte aligned for its tensor map")
    return build.tensor_maps.get(w, TC_HK, "decode_layer")


def _norm32(t):
    """The norm scale as a contiguous f32 tensor: itself where it is one
    (a caller holds the result until the launch: a converted copy freed
    earlier could hand its memory to the next allocation)."""
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.contiguous().float()


def _attn_args(lp, x, ck, cv, pos, alive, num_heads, head_dim, rope_theta, window, eps):
    h, hd = num_heads, head_dim
    kvh = ck.shape[3]
    bias = [lp.get(n) for n in ("bq", "bk", "bv")]
    _check_operands(x.dtype, x=x, ck=ck, cv=cv, wq=lp["wq"], wk=lp["wk"], wv=lp["wv"],
                    wo=lp["wo"], bq=bias[0], bk=bias[1], bv=bias[2])
    if pos.dtype != torch.int32 or not pos.is_contiguous():
        raise TypeError("pos must be a contiguous int32 tensor")
    if alive is not None and (alive.dtype != torch.bool or not alive.is_contiguous()):
        raise TypeError("alive must be a contiguous bool tensor")
    if lp["wq"].shape[-1] != h * hd or lp["wk"].shape[-1] != kvh * hd:
        raise ValueError(f"wq/wk do not hold {h} / {kvh} heads of {hd}")
    P = build.ptr
    return ([_map(lp["wq"]), _map(lp["wk"]), _map(lp["wv"]), *(P(t) for t in bias),
             _map(lp["wo"]), P(ck), P(cv), P(pos), P(alive)],
            [-math.log(rope_theta) if rope_theta > 0 else 0.0, int(rope_theta > 0), int(window),
             1.0 / math.sqrt(hd)])


def _attn_phase_tc(lp, x, ck, cv, pos, res, plans, *, num_heads, head_dim, rope_theta,
                   window, eps, alive):
    """``decode_layer_attn_phase_tc``: the attention phase on the wgmma
    path (four launches)."""
    m, b, d = x.shape
    s_cache, kvh = ck.shape[2], ck.shape[3]
    _check_operands(x.dtype, res=res)
    sc = _tc_scratch(x, s_cache, num_heads, kvh, head_dim, 0)
    w, tail = _attn_args(lp, x, ck, cv, pos, alive, num_heads, head_dim, rope_theta, window, eps)
    out, norm = torch.empty_like(x), _norm32(lp["attn_norm"])
    P = build.ptr
    fn = build.entry("decode_layer", "decode_layer_attn_phase_tc", _ATTN_TC_SIG)
    build.check(fn(P(x), P(norm), eps, *w, P(res), P(sc["qkv"]),
                   P(sc["attn"]), P(out), P(sc["part"]),
                   sc["n_part"], m, b, d, s_cache, num_heads, kvh, head_dim, *tail,
                   plans["qkv"].split, plans["out"].split, build.stream_ptr(x)),
                "decode_layer attention phase (wgmma)")
    return out


def _ffn_phase_tc(x, mlp_norm, w_gate, w_up, w_down, res, plans, *, eps):
    """``decode_layer_ffn_phase_tc``: the FFN phase on the wgmma path (two
    launches)."""
    m, b, d = x.shape
    ff = w_gate.shape[2]
    _check_operands(x.dtype, x=x, w_gate=w_gate, w_up=w_up, w_down=w_down, res=res)
    sc = _tc_scratch(x, 0, 0, 0, 0, ff)
    out, norm = torch.empty_like(x), _norm32(mlp_norm)
    P = build.ptr
    fn = build.entry("decode_layer", "decode_layer_ffn_phase_tc", _FFN_TC_SIG)
    build.check(fn(P(x), P(norm), eps, _map(w_gate), _map(w_up), _map(w_down),
                   P(res), P(sc["hid"]), P(out), m, b, d, ff, plans["gate_up"].split,
                   plans["down"].split, build.stream_ptr(x)), "decode_layer FFN phase (wgmma)")
    return out


def _layer_tc(lp, x, ck, cv, pos, plans, *, num_heads, head_dim, rope_theta, window, eps,
              alive):
    """``decode_layer_tc``: the whole layer on the wgmma path, one call
    into the library, six launches."""
    m, b, d = x.shape
    s_cache, kvh = ck.shape[2], ck.shape[3]
    ff = lp["w_gate"].shape[2]
    _check_operands(x.dtype, w_gate=lp["w_gate"], w_up=lp["w_up"], w_down=lp["w_down"])
    sc = _tc_scratch(x, s_cache, num_heads, kvh, head_dim, ff)
    w, tail = _attn_args(lp, x, ck, cv, pos, alive, num_heads, head_dim, rope_theta, window, eps)
    out = torch.empty_like(x)
    norms = _norm32(lp["attn_norm"]), _norm32(lp["mlp_norm"])
    P = build.ptr
    fn = build.entry("decode_layer", "decode_layer_tc", _LAYER_TC_SIG)
    build.check(fn(P(x), P(norms[0]), P(norms[1]), eps,
                   *w[:7], _map(lp["w_gate"]), _map(lp["w_up"]), _map(lp["w_down"]), *w[7:],
                   P(sc["qkv"]), P(sc["attn"]), P(sc["x2"]), P(sc["hid"]), P(out),
                   P(sc["part"]), sc["n_part"], m, b, d, s_cache, num_heads, kvh, head_dim, ff,
                   *tail, plans["qkv"].split, plans["out"].split, plans["gate_up"].split,
                   plans["down"].split, build.stream_ptr(x)), "decode_layer (wgmma)")
    return out


def _dt(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def decode_layer_attn_cuda(lp, x, ck, cv, pos, *, num_heads, head_dim, rope_theta,
                           window: int = 0, eps: float = 1e-5, alive=None):
    """The attention phase on the card: four launches on the wgmma path
    (bf16), six on the lanes matvec (see the note in csrc/decode_layer.cu).  Same
    contract as :func:`decode_layer_attn_plain`."""
    kw = dict(num_heads=num_heads, head_dim=head_dim, rope_theta=rope_theta, window=window,
              eps=eps, alive=alive)
    m, b, d = x.shape
    plans = attn_plans(m, b, d, num_heads, ck.shape[3], head_dim, _dt(x))
    if plans is not None:
        return _attn_phase_tc(lp, x, ck, cv, pos, None, plans, **kw), ck, cv
    return _attn_phase(lp, x, ck, cv, pos, None, **kw), ck, cv


def ffn_cuda(x, mlp_norm, w_gate, w_up, w_down, *, eps: float = 1e-5):
    """The FFN phase on the card: two launches on the wgmma path, four on
    the lanes matvec.  Same contract as :func:`ffn_plain`."""
    m, b, d = x.shape
    ff = w_gate.shape[2]
    plans = ffn_plans(m, b, d, ff, _dt(x))
    if plans is not None:
        return _ffn_phase_tc(x, mlp_norm, w_gate, w_up, w_down, None, plans, eps=eps)
    return _ffn_phase(x, mlp_norm, w_gate, w_up, w_down, None, eps=eps)


def decode_layer_cuda(lp, x, ck, cv, pos, *, num_heads, head_dim, rope_theta,
                      window: int = 0, eps: float = 1e-5, alive=None):
    """One dense decode layer for the whole (M, B) grid: the two phases,
    each adding its residual in its last epilogue (six launches on the
    wgmma path, ten on the lanes matvec).  Same contract as
    :func:`decode_layer_plain`; the cache is appended in place."""
    m, b, d = x.shape
    plans = layer_plans(m, b, d, num_heads, ck.shape[3], head_dim, lp["w_gate"].shape[2], _dt(x))
    if plans is not None:
        return _layer_tc(lp, x, ck, cv, pos, plans, num_heads=num_heads, head_dim=head_dim,
                         rope_theta=rope_theta, window=window, eps=eps, alive=alive), ck, cv
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
