"""The chunkwise mLSTM from zero state: the plain PyTorch version and the
launcher of its Hopper kernel (``csrc/mlstm_chunk.cu``).

Port of ``repro/kernels/mlstm_chunk.py`` (the Pallas ``_kernel``) with the
oracle of ``repro/kernels/ref.py`` (``mlstm_chunkwise``, which is the
model's chunkwise scan from C = 0, n = 0, m = -1e30): the plain version is
the port's ``models/ssm.mlstm_sequence`` from that state.  The chunk is
clamped to a divisor of S, as the reference clamps it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30


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


def mlstm_chunkwise_cuda(q, k, v, lf, li, *, chunk: int = 64):
    """The Hopper kernels (a state pass over 64 x 64 tiles of C, then an
    output pass): same contract as the plain version; q, k, v contiguous
    CUDA tensors of one dtype (float32 or bfloat16), hd a multiple of 64,
    the clamped chunk at most 64.  The passes meet in an f32 partials
    buffer of hd / 64 * (hd + chunk + 1) elements per step and lane (134 MB
    at the xlstm-1.3b profiler shape)."""
    _check(q, k, v, lf, li)
    m, b, h, s, hd = q.shape
    for name, a in (("q", q), ("k", k), ("v", v)):
        if not a.is_cuda or not a.is_contiguous() or a.dtype != q.dtype:
            raise ValueError(f"{name} must be a contiguous CUDA tensor of {q.dtype}")
    cs = chunk_size(s, chunk)
    if hd % 64 or cs > 64:
        raise ValueError(f"the kernel takes hd in multiples of 64 and chunks of at most 64, "
                         f"not hd={hd}, chunk={cs}")
    lf = lf.to(dtype=torch.float32).contiguous()
    li = li.to(dtype=torch.float32).contiguous()
    lanes = m * b * h
    hs = torch.empty_like(q)
    kw = dict(dtype=torch.float32, device=q.device)
    C, n, mm = (torch.empty(m, b, h, hd, hd, **kw), torch.empty(m, b, h, hd, **kw),
                torch.empty(m, b, h, **kw))
    elems = build.entry("mlstm_chunk", "mlstm_chunkwise_scratch_elems", "iiii", restype="q")
    scratch = torch.empty(elems(lanes, s, hd, cs), **kw)
    fn = build.entry("mlstm_chunk", "mlstm_chunkwise", "i" + "p" * 10 + "iiii" + "fp")
    P = build.ptr
    build.check(fn(build.dtype_code(q), P(q), P(k), P(v), P(lf), P(li), P(hs), P(C), P(n),
                   P(mm), P(scratch), lanes, s, hd, cs, math.sqrt(hd), build.stream_ptr(q)),
                "mlstm_chunkwise")
    return hs, (C, n, mm)
