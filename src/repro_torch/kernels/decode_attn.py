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

import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels.chunk_prefill_attn import split_ranges

NEG_INF = -1e30
# csrc/decode_attn.cu: slots per tile, most splits (CTAs of a cluster),
# query heads per kv head (one mma fragment's rows), head_dim
TILE, MAX_SPLITS, MAX_G, MAX_HD = 64, 8, 16, 128


@dataclass(frozen=True)
class Plan:
    """How one call runs: the 64-slot tiles of [0, S), the CTAs (one
    cluster) per (lane, kv head) that split a lane's valid tiles, their
    slot ranges [a, b) in order where kv_len = S (``split_slots`` gives
    them for any kv_len), and the grid (splits, kv heads, lanes)."""
    tiles: int
    splits: int
    ranges: tuple[tuple[int, int], ...]
    grid: tuple[int, int, int]


def split_slots(kv_len: int, splits: int) -> list[tuple[int, int]]:
    """The kernel's ranges for one lane: the ceil(kv_len / 64) tiles of its
    valid prefix split into ``splits`` contiguous ranges (split s: tiles
    [s n // splits, (s + 1) n // splits)), as slots clipped to kv_len; a
    split with no tile gets an empty range."""
    n = math.ceil(kv_len / TILE)
    return [(min(a * TILE, kv_len), min(b * TILE, kv_len)) for a, b in split_ranges(n, splits)]


@functools.lru_cache(maxsize=256)
def launch_plan(lanes: int, s: int, h: int, kvh: int, hd: int,
                dtype: str = "bfloat16") -> Plan:
    """The launch of ``csrc/decode_attn.cu`` (bf16 and f32 alike): clusters
    of min(ceil(S / 64), 8) CTAs.  The split count reads S alone, not the
    lanes or the card, and the ranges a lane's kv_len alone, so a lane's
    output never depends on M, B or K.  Raises on a shape the kernel does
    not take."""
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"the kernel takes float32 or bfloat16, not {dtype}")
    if s < 1 or kvh < 1 or h % kvh or h // kvh > MAX_G or hd > MAX_HD or hd % 8 or hd < 8:
        raise ValueError(f"the kernel takes head_dim <= {MAX_HD} in multiples of 8 and at most "
                         f"{MAX_G} query heads per kv head, not hd={hd}, H={h}, KVH={kvh}")
    tiles = math.ceil(s / TILE)
    splits = min(tiles, MAX_SPLITS)
    return Plan(tiles, splits, tuple(split_slots(s, splits)), (splits, kvh, lanes))


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


@functools.cache
def _kernel():
    """The C entry point, resolved once."""
    return build.entry("decode_attn", "decode_attention", "ipppppiiiiifip")


def decode_attention_cuda(q, k, v, kv_len):
    """The Hopper kernel: same contract as the plain version; G = H / KVH
    up to 16, head_dim up to 128 in multiples of 8.  One launch, planned
    by :func:`launch_plan`; no scratch."""
    _check(q, k, v, kv_len)
    m, b, h, hd = q.shape
    s, kvh = k.shape[2], k.shape[3]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or not t.is_contiguous() or t.dtype != q.dtype:
            raise ValueError(f"{name} must be a contiguous CUDA tensor of {q.dtype}")
    plan = launch_plan(m * b, s, h, kvh, hd, str(q.dtype).removeprefix("torch."))
    lens = kv_len
    if lens.dtype != torch.int32 or lens.device != q.device or not lens.is_contiguous():
        lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    build.check(_kernel()(build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          lens.data_ptr(), out.data_ptr(), m * b, s, h, kvh, hd, math.sqrt(hd),
                          plan.splits, build.stream_ptr(q)), "decode_attention")
    return out


def launch_floor(plan: Plan, device) -> None:
    """One launch of an empty kernel on ``plan``'s grid and cluster shape:
    the latency floor the kernel is measured against (its device time
    queued behind other work).  Not on any path of the port."""
    fn = build.entry("decode_attn", "decode_attention_floor", "iiip")
    build.check(fn(plan.splits, plan.grid[1], plan.grid[2],
                   torch.cuda.current_stream(device).cuda_stream), "decode_attention_floor")
