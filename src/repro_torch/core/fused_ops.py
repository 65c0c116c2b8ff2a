"""NetFuse merged ("grouped") op counterparts (port of
``repro.core.fused_ops``).

Every weighted op has a more general counterpart that supports
input-weight local computation (paper Table 1): matmul -> batch matmul
(merged along Batch), convolution -> grouped convolution, layer norm ->
group norm (both along Channel), batch norm -> batch norm; elementwise
ops, pooling and activations don't care.

Two equivalent forms, as in the reference: the instance-axis form
(a leading M axis on activations and weights) and the concat form (the
paper's tensors concatenated along Batch or Channel).  Layouts are the
reference's: convolutions take NHWC activations and HWIO weights, so the
tests compare like with like (the CNN model keeps its weights in
``F.conv2d``'s layout instead and calls :func:`conv2d_same`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Matrix multiplication -> batch matrix multiplication  (merge dim: Batch)
# ---------------------------------------------------------------------------


def batch_matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """x (M, ..., D) @ w (M, D, F) [+ b (M, F)] -> (M, ..., F): each
    instance's inputs only touch that instance's weights."""
    m, d = x.shape[0], x.shape[-1]
    y = torch.matmul(x.reshape(m, -1, d), w).reshape(*x.shape[:-1], w.shape[-1])
    if b is not None:
        y = y + b.reshape(b.shape[0], *([1] * (y.ndim - 2)), b.shape[-1])
    return y


def batch_matmul_concat(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Concat (paper) form: x (M*B, D) concatenated along the batch,
    w (M, D, F) -> (M*B, F)."""
    m = w.shape[0]
    y = torch.matmul(x.reshape(m, -1, x.shape[-1]), w)
    if b is not None:
        y = y + b[:, None, :]
    return y.reshape(-1, y.shape[-1])


# ---------------------------------------------------------------------------
# Convolution -> grouped convolution  (merge dim: Channel)
# ---------------------------------------------------------------------------


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (low, high) with the odd
    pixel at the high end.  A 7x7/2 conv on 224 pads (2, 3), a 3x3/2 conv
    on an even size (0, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w: torch.Tensor, *, groups: int, stride: int = 1) -> torch.Tensor:
    """Grouped conv with XLA's SAME padding on NCHW tensors (a channels-last
    tensor stays channels-last): x (B, G*Cin, H, W), w (G*Cout, Cin, K, K).
    ``F.conv2d``'s own padding is symmetric, so the asymmetric SAME padding
    goes through ``F.pad``."""
    kh, kw = w.shape[2], w.shape[3]
    ph, pw = same_padding(x.shape[2], kh, stride), same_padding(x.shape[3], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]), groups=groups)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, stride=stride, groups=groups)


def grouped_conv2d(x: torch.Tensor, w: torch.Tensor, *, groups: int, stride: int = 1,
                   padding: str = "SAME") -> torch.Tensor:
    """Grouped 2-D convolution, NHWC / HWIO: x (B, H, W, Cin*G), w (K, K,
    Cin, Cout*G).  ``groups`` is the total number of input-weight local
    groups: merging M convs of G groups each gives an M*G-group conv."""
    if padding != "SAME":
        raise ValueError(f"only SAME padding is ported, not {padding!r}")
    y = conv2d_same(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), groups=groups, stride=stride)
    return y.permute(0, 2, 3, 1)


def merge_conv_weights(ws: list[torch.Tensor]) -> torch.Tensor:
    """Concatenate M conv weights (K, K, Cin, Cout) along Cout."""
    return torch.cat(ws, dim=-1)


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Max pool with XLA's SAME padding (padded with -inf) on NCHW."""
    ph, pw = same_padding(x.shape[2], k, stride), same_padding(x.shape[3], k, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, k, stride)


# ---------------------------------------------------------------------------
# Layer norm -> group norm  (merge dim: Channel)
# ---------------------------------------------------------------------------


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *, num_groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """Group norm over the last (channel) axis: x (..., G*C); each group of
    C channels with its own statistics (population variance); scale and
    bias (G*C,)."""
    *lead, ch = x.shape
    xg = x.reshape(*lead, num_groups, ch // num_groups)
    mean = xg.mean(-1, keepdim=True)
    var = xg.var(-1, keepdim=True, correction=0)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return xg.reshape(*lead, ch) * scale + bias


def merged_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None, *,
                      eps: float = 1e-5) -> torch.Tensor:
    """Instance-axis layer norm: x (M, ..., D), scale and bias (M, D); each
    instance with its own statistics and affine parameters."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    y = (x - mean) * torch.rsqrt(var + eps)
    m, d = scale.shape
    bshape = (m,) + (1,) * (x.ndim - 2) + (d,)
    y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    return y


# ---------------------------------------------------------------------------
# Batch norm (inference) -- channels concatenate directly
# ---------------------------------------------------------------------------


def merged_batch_norm(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """Inference batch norm over the last axis: x (..., C_total), stats
    and affine (C_total,), the per-instance ones concatenated."""
    inv = torch.rsqrt(var + eps) * scale
    return x * inv + (bias - mean * inv)


# ---------------------------------------------------------------------------
# Embedding lookup (instance-axis form)
# ---------------------------------------------------------------------------


def merged_embedding(ids: torch.Tensor, table: torch.Tensor,
                     instances: list[int] | None = None) -> torch.Tensor:
    """ids: (M, ...), table: (M_t, V, D) -> (M, ..., D).

    Each instance's ids index only that instance's table.  ``instances``
    maps row i of ``ids`` to table row ``instances[i]`` (per-lane views:
    no copy of the tables); by default row i reads table i."""
    if instances is None:                   # one gather for all instances
        m = torch.arange(ids.shape[0], device=ids.device)
        return table[m.reshape(-1, *([1] * (ids.ndim - 1))), ids.long()]
    return torch.stack([table[t][ids[i].long()] for i, t in enumerate(instances)])


# ---------------------------------------------------------------------------
# Form conversion -- the reshape Algorithm 1 inserts
# ---------------------------------------------------------------------------


def batch_to_channel(x: torch.Tensor, m: int) -> torch.Tensor:
    """(M*B, ..., D) concatenated along Batch -> (B, ..., M*D) along Channel."""
    xb = x.reshape(m, -1, *x.shape[1:]).movedim(0, -2)      # (B, ..., M, D)
    return xb.reshape(*xb.shape[:-2], m * x.shape[-1])


def channel_to_batch(x: torch.Tensor, m: int) -> torch.Tensor:
    """(B, ..., M*D) concatenated along Channel -> (M*B, ..., D) along Batch."""
    xb = x.reshape(*x.shape[:-1], m, x.shape[-1] // m).movedim(-2, 0)   # (M, B, ..., D)
    return xb.reshape(-1, *xb.shape[2:])
