"""The chunkwise mLSTM from zero state: the plain PyTorch version and the
launcher of its Hopper kernel (``csrc/mlstm_chunk.cu``).

Port of ``repro/kernels/mlstm_chunk.py`` (the Pallas ``_kernel``) with the
oracle of ``repro/kernels/ref.py`` (``mlstm_chunkwise``, which is the
model's chunkwise scan from C = 0, n = 0, m = -1e30): the plain version is
the model's chunkwise scan :func:`mlstm_sequence` (which ``models/ssm``
imports) from that state.  The chunk is
clamped to a divisor of S, as the reference clamps it.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
# csrc/mlstm_chunk.cu: its warps, the largest chunk, the largest cluster,
# pass 2's strip of C's columns, pass 1's piece rows and the row padding
# of q / k tiles and of v's rows per dtype (rows, padding, v row, bytes),
# the earlier chunks one round of pass 1's m recurrence reads, shared
# memory a block may use on sm_90
WARPS, MAX_CS, MAX_CLUSTER, STRIP, CHAIN = 8, 128, 8, 64, 256
H100_SMS = 132
TILES = {"bfloat16": (64, 8, STRIP + 24, 2), "float32": (32, 4, STRIP + 12, 4)}
MAX_SMEM = 232448


@dataclass(frozen=True)
class Plan:
    """How one call runs.  Pass 1, w and the gates: once per (lane, chunk),
    hd split over a cluster of ``kcluster`` CTAs (grid ``grid1``).  Pass 2,
    the state: a CTA owns blocks of C's ``rows`` rows (from r * rows) by
    ``strip`` columns.  Several chunks (``resident``): grid ``grid2`` =
    (hd / rows, hd / strip, lanes), the hd / rows CTAs of a strip a
    cluster, the block in registers over the chunks.  One chunk: grid
    (hd / rows, ``groups``, lanes), CTA (r, g) walking strips g, g +
    groups, ...  Shared memory of a CTA of each pass; ``record`` f32 per
    (lane, chunk) from pass 1 to 2."""
    kcluster: int
    rows: int
    strip: int
    groups: int
    resident: bool
    grid1: tuple[int, int, int]
    grid2: tuple[int, int, int]
    smem1: int
    smem2: int
    record: int


def record_floats(cs: int) -> int:
    """The record pass 1 leaves for a (lane, chunk): w (csp x csp), its row
    sums, a_inter, round(w_end), mt (csp each), decay0 and three spare; csp
    is cs rounded up to 16."""
    csp = 16 * math.ceil(cs / 16)
    return csp * csp + 4 * csp + 4


def smem_bytes(cs: int, hd: int, rows: int, resident: bool,
               dtype: str = "bfloat16") -> tuple[int, int]:
    """(pass 1, pass 2) shared memory of a CTA, the sums
    ``csrc/mlstm_chunk.cu`` carves.  Pass 1: q / k pieces (two buffers; w
    over them afterwards), the warps' q k^T partials, the gates, the ends of
    earlier chunks.  Pass 2 with one chunk: k's block, two buffers of v's
    strip with n's columns, the record's round(w), the gate vectors; with
    several: bf16 q (with the q C0 partials over it), k, v, C0 as hi and
    lo; f32 k (then q transposed), v, C0 (with the partials over it); the
    same round(w) and vectors."""
    dp, pad, vs, esz = TILES[dtype]
    csp = 16 * math.ceil(cs / 16)
    ks = WARPS // (csp // 16)
    one = 4 * csp * (dp + pad) * esz + 4 * ks * csp * csp + 4 * (5 * csp + 2 * CHAIN + 4)
    kq, qcx = csp * (rows + pad) * esz, 4 * csp * (STRIP + 8)
    wsm, vec = csp * csp * esz, 4 * (5 * csp + 4)
    if not resident:
        two = kq + 2 * csp * vs * esz + wsm + vec
    elif esz == 2:
        two = max(kq, qcx) + kq + csp * vs * 2 + 4 * rows * vs + wsm + vec
    else:
        two = (max(kq, 4 * rows * (csp + 2)) + csp * vs * 4 + max(4 * rows * (STRIP + 12), qcx)
               + wsm + vec)
    return one, two


@functools.lru_cache(maxsize=256)
def launch_plan(lanes: int, s: int, hd: int, cs: int, dtype: str = "bfloat16",
                sms: int = H100_SMS) -> Plan:
    """The two launches of ``csrc/mlstm_chunk.cu`` for the clamped chunk
    ``cs``: pass 1 splits hd into 128-row shares over a cluster (one CTA
    where hd is not a multiple of 128); pass 2 gives each CTA 128 rows (64
    where hd is not a multiple of 128) of 64-column strips; with one chunk
    the strips of a block split over the fewest CTAs that make two waves
    of ``sms``.  A pure function of the shapes; raises on one the kernel
    does not take."""
    if dtype not in TILES:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {dtype}")
    rows = 128 if hd % 128 == 0 else 64
    if (hd % 64 or not 1 <= cs <= MAX_CS or s < cs or s % cs or not 1 <= lanes <= 65535
            or hd // rows > MAX_CLUSTER or s // cs > 65535):
        raise ValueError(f"the kernel takes hd in multiples of 64 up to {MAX_CLUSTER} blocks of "
                         f"rows and chunks of 1..{MAX_CS} dividing S, not hd={hd}, S={s}, "
                         f"chunk={cs}")
    kcluster = hd // 128 if hd % 128 == 0 else 1
    resident = s // cs > 1
    blocks = hd // rows
    groups = hd // STRIP if resident else min(hd // STRIP,
                                              max(1, math.ceil(2 * sms / (blocks * lanes))))
    smem1, smem2 = smem_bytes(cs, hd, rows, resident, dtype)
    return Plan(kcluster, rows, STRIP, groups, resident, (kcluster, s // cs, lanes),
                (blocks, groups, lanes), smem1, smem2, record_floats(cs))


def chunk_size(s: int, chunk: int) -> int:
    """The largest divisor of ``s`` not above ``chunk``."""
    cs = min(chunk, s)
    while s % cs:
        cs -= 1
    return cs


def _check(q, k, v, lf, li):
    if q.ndim != 5 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be (M, B, H, S, hd) alike; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if lf.shape != q.shape[:4] or li.shape != q.shape[:4]:
        raise ValueError(f"lf, li must be {tuple(q.shape[:4])}; got {tuple(lf.shape)}, "
                         f"{tuple(li.shape)}")


def zero_state(q):
    """C = 0, n = 0, m = -1e30 for the (M, B, H) lanes of q."""
    lead, hd = q.shape[:3], q.shape[4]
    kw = dict(dtype=torch.float32, device=q.device)
    return (torch.zeros(*lead, hd, hd, **kw), torch.zeros(*lead, hd, **kw),
            torch.full(lead, NEG_INF, **kw))


def _mlstm_chunk(carry, blk, hd: int):
    """One chunk.  carry: (C (.., hd, hd), n (.., hd), m (..)) f32 with
    leading dims (M, B, H); blk: q, k, v (M, B, H, Cs, hd) in their storage
    dtype, lf, li (M, B, H, Cs) f32.  Contractions take storage-dtype
    inputs and accumulate in f32, as the reference's
    ``preferred_element_type`` does."""
    C0, n0, m0 = carry
    q, k, v, lf, li = blk
    cs = q.shape[-2]
    f32 = torch.float32
    b = torch.cumsum(lf, dim=-1)
    g = torch.cummax(li - b, dim=-1).values
    mt = b + torch.maximum(m0[..., None], g)
    a_inter = torch.exp(b + m0[..., None] - mt)
    logD = li[..., None, :] - b[..., None, :] + b[..., :, None] - mt[..., None]
    tri = torch.tril(torch.ones((cs, cs), dtype=torch.bool, device=q.device))
    # the mask goes in before the exp: above the diagonal logD can pass 88
    # (a strong forget gate over the chunk), and exp's gradient there,
    # inf times the masked 0, would be NaN; the values are the same
    D = torch.exp(torch.where(tri, logD, torch.full((), NEG_INF, dtype=f32, device=q.device)))

    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    s_qk = (qf @ kf.transpose(-1, -2)) / math.sqrt(hd)
    w = s_qk * D
    num = w.to(v.dtype).to(f32) @ vf
    num = num + a_inter[..., None] * (qf @ C0) / math.sqrt(hd)
    den = w.sum(-1) + a_inter * (qf @ n0[..., None])[..., 0] / math.sqrt(hd)
    h = num / torch.maximum(den.abs(), torch.exp(-mt))[..., None]

    m_end = mt[..., -1]
    w_end = torch.exp(li + b[..., -1:] - b - m_end[..., None])
    decay0 = torch.exp(b[..., -1] + m0 - m_end)
    kw = w_end.to(v.dtype).to(f32)[..., None] * kf
    C_new = decay0[..., None, None] * C0 + kw.transpose(-1, -2) @ vf
    n_new = decay0[..., None] * n0 + (w_end.to(k.dtype).to(f32)[..., None] * kf).sum(-2)
    return (C_new, n_new, m_end), h.to(v.dtype)


def mlstm_sequence(q, k, v, lf, li, state, *, chunk: int = 64):
    """Chunkwise mLSTM continuing ``state`` = (C, n, m).  q, k, v
    (M, B, H, S, hd); lf, li (M, B, H, S).  Returns (h (M, B, H, S, hd),
    new state)."""
    s, hd = q.shape[3], q.shape[4]
    cs = min(chunk, s)
    while s % cs:
        cs -= 1
    hs = []
    for i in range(0, s, cs):
        sl = slice(i, i + cs)
        state, h = _mlstm_chunk(state, (q[..., sl, :], k[..., sl, :], v[..., sl, :],
                                        lf[..., sl], li[..., sl]), hd)
        hs.append(h)
    return torch.cat(hs, dim=3), state


def mlstm_chunkwise_plain(q, k, v, lf, li, *, chunk: int = 64):
    """q, k, v (M, B, H, S, hd); lf, li (M, B, H, S) f32.  Returns (h
    (M, B, H, S, hd) in q's dtype, (C (M, B, H, hd, hd), n (M, B, H, hd),
    m (M, B, H)) f32)."""
    _check(q, k, v, lf, li)
    h, state = mlstm_sequence(q, k, v, lf.float(), li.float(), zero_state(q),
                                  chunk=chunk)
    return h.to(q.dtype), state


class Chunkwise(torch.autograd.Function):
    """The chunkwise mLSTM from zero state under autograd.

    ``forward`` runs ``fwd`` (the kernel's launcher on the card; a test
    may pass the plain version), which allocates the state it returns.
    ``backward`` recomputes the reference's training math -- the model's
    chunkwise scan :func:`mlstm_sequence` from C = 0, n = 0, m =
    -1e30 -- and differentiates it: the reference trains on that XLA scan
    because ``pallas_call`` has no VJP, and the port writes no backward
    kernel either.  Gradients reach q, k, v, lf and li."""

    @staticmethod
    def forward(ctx, fwd, chunk, q, k, v, lf, li):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(q, k, v, lf, li)
        h, (C, n, m) = fwd(q, k, v, lf, li, chunk=chunk)
        return h, C, n, m

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[2:]
        ins = [t.detach().requires_grad_(r) for t, r in zip(ctx.saved_tensors, need)]
        q, k, v, lf, li = ins
        with torch.enable_grad():
            h, state = mlstm_sequence(q, k, v, lf.float(), li.float(), zero_state(q),
                                          chunk=ctx.chunk)
            pairs = [(o, g) for o, g in zip((h.to(q.dtype),) + state, grads) if g is not None]
            wrt = [t for t, r in zip(ins, need) if r]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                           allow_unused=True) if pairs and wrt else ())
        return (None, None) + tuple(next(got, None) if r else None for r in need)


def mlstm_chunkwise_grad(fwd, q, k, v, lf, li, *, chunk: int = 64):
    """``fwd`` (same contract as the plain version) under :class:`Chunkwise`."""
    h, C, n, m = Chunkwise.apply(fwd, chunk, q, k, v, lf, li)
    return h, (C, n, m)


@functools.cache
def _kernel():
    """The C entry point, resolved once."""
    return build.entry("mlstm_chunk", "mlstm_chunkwise",
                       "i" + "p" * 10 + "iiii" + "f" + "iiiii" + "p")


def mlstm_chunkwise_cuda(q, k, v, lf, li, *, chunk: int = 64):
    """The Hopper kernels (two launches, planned by :func:`launch_plan`):
    same contract as the plain version; q, k, v contiguous CUDA tensors of
    one dtype (float32 or bfloat16), hd a multiple of 64 up to 1024, the
    clamped chunk at most 128.  Pass 1 leaves cs^2 + 4 cs floats per (lane,
    chunk) for pass 2; the partial sums of q C0 meet in shared memory."""
    _check(q, k, v, lf, li)
    m, b, h, s, hd = q.shape
    for name, a in (("q", q), ("k", k), ("v", v)):
        if not a.is_cuda or not a.is_contiguous() or a.dtype != q.dtype:
            raise ValueError(f"{name} must be a contiguous CUDA tensor of {q.dtype}")
    cs = chunk_size(s, chunk)
    lanes = m * b * h
    plan = launch_plan(lanes, s, hd, cs, str(q.dtype).removeprefix("torch."),
                       build.sm_count(q.device))
    lf = lf.to(dtype=torch.float32).contiguous()
    li = li.to(dtype=torch.float32).contiguous()
    hs = torch.empty_like(q)
    kw = dict(dtype=torch.float32, device=q.device)
    C, n, mm = (torch.empty(m, b, h, hd, hd, **kw), torch.empty(m, b, h, hd, **kw),
                torch.empty(m, b, h, **kw))
    rec = torch.empty(lanes * (s // cs) * plan.record, **kw)
    P = build.ptr
    build.check(_kernel()(build.dtype_code(q), P(q), P(k), P(v), P(lf), P(li), P(hs), P(C),
                          P(n), P(mm), P(rec), lanes, s, hd, cs, math.sqrt(hd), plan.kcluster,
                          plan.rows, plan.groups, plan.smem1, plan.smem2, build.stream_ptr(q)),
                "mlstm_chunkwise")
    return hs, (C, n, mm)
