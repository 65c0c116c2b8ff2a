"""The merged per-instance RMS norm: the plain PyTorch version and the
launcher of its Hopper kernel (``csrc/group_norm.cu``).

Port of ``repro/kernels/group_norm.py`` (the Pallas ``_kernel``) with the
oracle of ``repro/kernels/ref.py`` (``group_rms_norm``) beside it: row
(m, t) of x (M, T, D) is scaled by rsqrt of its own f32 mean square and by
instance m's scale (M, D), the result cast to x's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def _check(x, scale):
    if x.ndim != 3 or tuple(scale.shape) != (x.shape[0], x.shape[2]):
        raise ValueError(f"x must be (M, T, D) and scale (M, D); got {tuple(x.shape)}, "
                         f"{tuple(scale.shape)}")


def group_rms_norm_plain(x, scale, eps: float = 1e-5):
    """x (M, T, D), scale (M, D) -> (M, T, D) in x's dtype."""
    _check(x, scale)
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()[:, None, :]).to(x.dtype)


def group_rms_norm_cuda(x, scale, eps: float = 1e-5):
    """The Hopper kernel: same contract as the plain version; contiguous
    CUDA tensors of float32 or bfloat16, D a multiple of 8 up to 8192."""
    _check(x, scale)
    m, t, d = x.shape
    for name, a in (("x", x), ("scale", scale)):
        if not a.is_cuda or not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned CUDA tensor")
    if d % 8 or d > 8192:
        raise ValueError(f"the kernel takes D in multiples of 8 up to 8192, not {d}")
    out = torch.empty_like(x)
    fn = build.entry("group_norm", "group_rms_norm", "iipppiiifp")
    P = build.ptr
    build.check(fn(build.dtype_code(x), build.dtype_code(scale), P(x), P(scale), P(out),
                   m, t, d, eps, build.stream_ptr(x)), "group_rms_norm")
    return out
