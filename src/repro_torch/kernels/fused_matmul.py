"""The NetFuse merged matmul: the plain PyTorch version and the launcher
of its Hopper kernel (``csrc/fused_matmul.cu``).

Port of ``repro/kernels/fused_matmul.py`` (the Pallas ``_kernel`` and
``_bias_kernel``) with the oracle of ``repro/kernels/ref.py``
(``fused_matmul``) beside it: x (M, T, D) @ w (M, D, F) [+ b (M, F)] ->
(M, T, F); w in x's dtype, the sum in f32, the bias added in f32, the
result cast to x's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def _check(x, w, b):
    if x.ndim != 3 or w.ndim != 3 or w.shape[:2] != (x.shape[0], x.shape[2]):
        raise ValueError(f"x must be (M, T, D) and w (M, D, F); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (w.shape[0], w.shape[2]):
        raise ValueError(f"b must be ({w.shape[0]}, {w.shape[2]}); got {tuple(b.shape)}")


def fused_matmul_plain(x, w, b=None):
    """x (M, T, D) @ w (M, D, F) [+ b (M, F)] -> (M, T, F) in x's dtype."""
    _check(x, w, b)
    y = torch.bmm(x.float(), w.to(x.dtype).float())
    if b is not None:
        y = y + b.float()[:, None, :]
    return y.to(x.dtype)


def fused_matmul_cuda(x, w, b=None):
    """The Hopper kernel: same contract as the plain version; x and w
    contiguous CUDA tensors of float32 or bfloat16 (w is cast to x's dtype
    first where it differs), D and F multiples of 8."""
    _check(x, w, b)
    m, t, d = x.shape
    f = w.shape[2]
    w = w.to(x.dtype)
    for name, a in (("x", x), ("w", w)):
        if not a.is_cuda or not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned CUDA tensor")
    if d % 8 or f % 8:
        raise ValueError(f"the kernel takes D and F in multiples of 8, not D={d}, F={f}")
    bias = None if b is None else b.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty(m, t, f, dtype=x.dtype, device=x.device)
    fn = build.entry("fused_matmul", "fused_matmul", "ippppiiiip")
    P = build.ptr
    build.check(fn(build.dtype_code(x), P(x), P(w), P(bias), P(out), m, t, d, f,
                   build.stream_ptr(x)), "fused_matmul")
    return out
