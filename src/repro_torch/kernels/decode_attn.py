"""Single-token GQA decode attention over a prefix-valid KV cache: the
plain PyTorch version and the launcher of its Hopper kernel
(``csrc/decode_attn.cu``).

Port of ``repro/kernels/decode_attn.py`` (the Pallas ``_kernel``) with the
oracle of ``repro/kernels/ref.py`` (``decode_attention``) beside it: f32
scores and softmax, masked slots at -1e30, f32 accumulation, the output
in q's dtype.

Contract: ``1 <= kv_len[m, b] <= S``.  The serving path appends the new
token before it attends, so ``kv_len = min(pos + 1, S)`` is never 0.  At
``kv_len = 0`` the reference returns the mean of V over all S slots (a
uniform softmax over -1e30 scores); the kernel is not defined there.

Under tensor parallelism ``rank_kv_heads`` says which kv heads a rank's
block of query heads reads; ``ops.decode_attention_sharded`` runs the
kernel on that block.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30


def _check(q, k, v, kv_len):
    m, b, h, hd = q.shape
    if k.ndim != 5 or k.shape[:2] != (m, b) or k.shape[4] != hd or v.shape != k.shape:
        raise ValueError(f"k, v must be (M, B, S, KVH, {hd}); got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if h % k.shape[3]:
        raise ValueError(f"{h} query heads do not group over {k.shape[3]} kv heads")
    if tuple(kv_len.shape) != (m, b):
        raise ValueError(f"kv_len must be ({m}, {b}); got {tuple(kv_len.shape)}")


def rank_kv_heads(h: int, kvh: int, n: int, rank: int):
    """The kv heads that rank ``rank``'s contiguous block of ``h / n``
    query heads reads (q heads are laid out kvh-major: q head j reads kv
    head j // (h / kvh)).  Returns (lo, hi, index): the block reads kv
    heads [lo, hi); ``index`` is None when its q heads group evenly over
    them, the kernel's layout, else the local kv head of each q head
    (the block straddles a group boundary unevenly, and attention takes
    the reference's repeat form).  One device is ``n = 1``."""
    g, hl = h // kvh, h // n
    kv = [(rank * hl + j) // g for j in range(hl)]
    lo, hi = kv[0], kv[-1] + 1
    local = [i - lo for i in kv]
    per = hl // (hi - lo)
    even = per * (hi - lo) == hl and local == [j // per for j in range(hl)]
    return lo, hi, None if even else local


def decode_attention_plain(q, k, v, kv_len):
    """q (M, B, H, hd); k, v (M, B, S, KVH, hd); kv_len (M, B) int, the
    number of valid leading slots.  Returns (M, B, H, hd) in q's dtype."""
    _check(q, k, v, kv_len)
    m, b, h, hd = q.shape
    s, kvh = k.shape[2], k.shape[3]
    qg = q.reshape(m, b, kvh, h // kvh, hd).float()
    scores = torch.einsum("mbkgd,mbskd->mbkgs", qg, k.float()) / math.sqrt(hd)
    mask = torch.arange(s, device=q.device) < kv_len[..., None]          # (M,B,S)
    scores = torch.where(mask[:, :, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("mbkgs,mbskd->mbkgd", p, v.float())
    return o.reshape(m, b, h, hd).to(q.dtype)


def decode_attention_cuda(q, k, v, kv_len):
    """The Hopper kernel: same contract as the plain version; G = H / KVH
    up to 16, head_dim up to 128 in multiples of 8."""
    _check(q, k, v, kv_len)
    m, b, h, hd = q.shape
    s, kvh = k.shape[2], k.shape[3]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or not t.is_contiguous() or t.dtype != q.dtype:
            raise ValueError(f"{name} must be a contiguous CUDA tensor of {q.dtype}")
    if hd > 128 or hd % 8 or h // kvh > 16:
        raise ValueError(f"the kernel takes head_dim <= 128 in multiples of 8 and at most "
                         f"16 query heads per kv head, not hd={hd}, G={h // kvh}")
    lens = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    scratch = build.entry("decode_attn", "decode_attention_scratch_elems", "iiiii",
                          restype="q")
    n_part = scratch(m * b, s, h, kvh, hd)
    part = torch.empty(n_part, dtype=torch.float32, device=q.device)
    fn = build.entry("decode_attn", "decode_attention", "ipppppp" + "q" + "iiiii" + "fp")
    P = build.ptr
    build.check(fn(build.dtype_code(q), P(q), P(k), P(v), P(lens), P(out), P(part), n_part,
                   m * b, s, h, kvh, hd, math.sqrt(hd), build.stream_ptr(q)),
                "decode_attention")
    return out
