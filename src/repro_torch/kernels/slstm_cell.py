"""sLSTM cell -- the whole recurrent scan of one sLSTM block: the plain
PyTorch version and the launcher of its Hopper kernel
(``csrc/slstm_cell.cu``).

Port of ``repro/kernels/slstm_cell.py`` (the Pallas ``_kernel``) with the
oracle of ``repro/kernels/ref.py`` (``slstm_cell``) beside it.  Per step
and per head (block-diagonal recurrence, g in z, i, f, o):

    rec_g = h_{t-1} @ r_g
    lf = log_sigmoid(f);  m_t = max(lf + m_{t-1}, i)
    c_t = exp(lf + m_{t-1} - m_t) c + exp(i - m_t) tanh(z)
    n_t = exp(lf + m_{t-1} - m_t) n + exp(i - m_t)
    h_t = sigmoid(o) c_t / max(n_t, 1e-6)

Gate math in f32; h is rounded to its storage dtype every step, as
``ref.py`` and the reference's XLA path do (the Pallas kernel keeps it in
f32 within one call).  ``log_sigmoid`` is the stable
``min(x, 0) - log1p(exp(-|x|))``, so the neutral gates of a padded step
(input -1e30, forget +1e30) leave c, n and m exactly as they were.

The state (c, n, h, m) is updated in place.  ``alive`` (M, B) bool, when
given, leaves the state of every lane where it is False untouched: the
serving K-step block freezes a stopped lane that way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# CTAs of one thread-block cluster, which owns one (instance, head); a
# CTA's 256 threads split 4 x hd/CLUSTER gate columns into float4 quads
CLUSTER = 8
_THREADS = 256


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, max=0.0) - torch.log1p(torch.exp(-x.abs()))


def _check_shapes(pre, r, state, num_heads):
    m, b, s, four, d = pre.shape
    if four != 4 or d % num_heads:
        raise ValueError(f"pre must be (M, B, S, 4, D) with D % H == 0, got {tuple(pre.shape)}")
    hd = d // num_heads
    if tuple(r.shape) != (m, 4, num_heads, hd, hd):
        raise ValueError(f"r must be {(m, 4, num_heads, hd, hd)}, got {tuple(r.shape)}")
    for name, t in zip("cnhm", state):
        if tuple(t.shape) != (m, b, d):
            raise ValueError(f"state {name} must be {(m, b, d)}, got {tuple(t.shape)}")
    return m, b, s, d, hd


def slstm_cell_plain(pre, r, state, *, num_heads: int, alive=None):
    """pre (M, B, S, 4, D) gate pre-activations; r (M, 4, H, hd, hd);
    state (c, n, h, m) each (M, B, D): c/n/m f32, h in its storage dtype,
    updated in place.  Returns (hs (M, B, S, D) in h's dtype, state)."""
    m, b, s, d, hd = _check_shapes(pre, r, state, num_heads)
    c0, n0, h0, m0 = state
    rf = r.float()
    c, n, h, mst = c0.float(), n0.float(), h0, m0.float()
    hs = torch.empty((m, b, s, d), dtype=h0.dtype, device=pre.device)
    for t in range(s):
        hh = h.float().reshape(m, b, num_heads, hd)
        rec = torch.einsum("mbhd,mghde->mbghe", hh, rf).reshape(m, b, 4, d)
        pre_t = pre[:, :, t].float()
        zt, it, ft, ot = (pre_t[:, :, j] + rec[:, :, j] for j in range(4))
        lf = log_sigmoid(ft)
        mt = torch.maximum(lf + mst, it)
        fp = torch.exp(lf + mst - mt)
        ip = torch.exp(it - mt)
        c = fp * c + ip * torch.tanh(zt)
        n = fp * n + ip
        h = (torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)).to(h0.dtype)
        mst = mt
        hs[:, :, t] = h
    keep = None if alive is None else alive[..., None]
    for dst, new in zip(state, (c, n, h, mst)):
        dst.copy_(new if keep is None else torch.where(keep, new.to(dst.dtype), dst))
    return hs, state


def slstm_cell_cuda(pre, r, state, *, num_heads: int, alive=None):
    """The Hopper kernel: one launch scans all S steps; one cluster of
    CLUSTER CTAs per (instance, head) exchanges h through distributed
    shared memory each step.  Same contract as the plain version."""
    m, b, s, d, hd = _check_shapes(pre, r, state, num_heads)
    c, n, h, mst = state
    for name, t in (("pre", pre), ("r", r), ("c", c), ("n", n), ("h", h), ("m", mst)):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    if h.dtype != pre.dtype:
        raise TypeError(f"h is {h.dtype}, pre is {pre.dtype}: the kernel takes one dtype")
    for name, t in (("c", c), ("n", n), ("m", mst)):
        if t.dtype != torch.float32:
            raise TypeError(f"state {name} must be float32, got {t.dtype}")
    if alive is not None and (alive.dtype != torch.bool or not alive.is_contiguous()
                              or tuple(alive.shape) != (m, b)):
        raise TypeError("alive must be a contiguous (M, B) bool tensor")
    if hd % (4 * CLUSTER) or hd // CLUSTER > _THREADS:
        raise ValueError(f"the kernel takes head_dim a multiple of {4 * CLUSTER} "
                         f"up to {CLUSTER * _THREADS}, not {hd}")
    hs = torch.empty((m, b, s, d), dtype=h.dtype, device=pre.device)
    fn = build.entry("slstm_cell", "slstm_cell", "ii" + "p" * 8 + "iiiii" + "p")
    P = build.ptr
    build.check(fn(build.dtype_code(pre), build.dtype_code(r), P(pre), P(r), P(c), P(n),
                   P(h), P(mst), P(alive), P(hs), m, b, s, num_heads, hd,
                   build.stream_ptr(pre)), "slstm_cell")
    return hs, state
