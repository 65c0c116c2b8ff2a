"""The chunkwise mLSTM from zero state: the plain PyTorch version and the
launcher of its Hopper kernel (``csrc/mlstm_chunk.cu``).

Port of ``repro/kernels/mlstm_chunk.py`` (the Pallas ``_kernel``) with the
oracle of ``repro/kernels/ref.py`` (``mlstm_chunkwise``, which is the
model's chunkwise scan from C = 0, n = 0, m = -1e30): the plain version is
the port's ``models/ssm.mlstm_sequence`` from that state.  The chunk is
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


def mlstm_chunkwise_plain(q, k, v, lf, li, *, chunk: int = 64):
    """q, k, v (M, B, H, S, hd); lf, li (M, B, H, S) f32.  Returns (h
    (M, B, H, S, hd) in q's dtype, (C (M, B, H, hd, hd), n (M, B, H, hd),
    m (M, B, H)) f32)."""
    from repro_torch.models import ssm

    _check(q, k, v, lf, li)
    h, state = ssm.mlstm_sequence(q, k, v, lf.float(), li.float(), zero_state(q),
                                  chunk=chunk)
    return h.to(q.dtype), state


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
