"""The NetFuse merged matmul: the plain PyTorch version and the launcher
of its Hopper kernel (``csrc/fused_matmul.cu``).

Port of ``repro/kernels/fused_matmul.py`` (the Pallas ``_kernel`` and
``_bias_kernel``) with the oracle of ``repro/kernels/ref.py``
(``fused_matmul``) beside it: x (M, T, D) @ w (M, D, F) [+ b (M, F)] ->
(M, T, F); w in x's dtype, the sum in f32, the bias added in f32, the
result cast to x's dtype.

The reference's ``fused_matmul_sharded`` runs that kernel under
``shard_map`` on each rank's block, with no collective; here a rank
holds its block already (:func:`rank_block` cuts it from whole arrays,
:func:`assemble` puts the ranks' outputs back together) and
``ops.fused_matmul_sharded`` launches the same kernel on it.
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
    first where it differs), any shape."""
    _check(x, w, b)
    m, t, d = x.shape
    f = w.shape[2]
    w = w.to(x.dtype)
    for name, a in (("x", x), ("w", w)):
        if not a.is_cuda or not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned CUDA tensor")
    bias = None if b is None else b.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty(m, t, f, dtype=x.dtype, device=x.device)
    fn = build.entry("fused_matmul", "fused_matmul", "ippppiiiip")
    P = build.ptr
    build.check(fn(build.dtype_code(x), P(x), P(w), P(bias), P(out), m, t, d, f,
                   build.stream_ptr(x)), "fused_matmul")
    return out


# ---------------------------------------------------------------------------
# fused_matmul_sharded: a rank's block on a (data=D, model=T) mesh
# ---------------------------------------------------------------------------


def sharded_specs(m: int, f: int, d: int, t: int) -> dict[str, tuple]:
    """The mesh axis of each dim of x (M, T, D), w (M, D, F), b (M, F) and
    the output (M, T, F) under the reference's ``fused_matmul_sharded`` on
    a (data=d, model=t) mesh (``serve_rules``' "instances" and "mlp" through
    ``Rules.spec``): instances on "data" where d divides M, F on "model"
    where t divides F, else replicated."""
    inst = "data" if m % d == 0 else None
    mlp = "model" if f % t == 0 else None
    return {"x": (inst, None, None), "w": (inst, None, mlp), "b": (inst, mlp),
            "out": (inst, None, mlp)}


def _cut(a, spec, index: dict, sizes: dict):
    for dim, axis in enumerate(spec):
        if axis is not None:
            a = a.chunk(sizes[axis], dim)[index[axis]]
    return a.contiguous()


def rank_block(x, w, b, data_rank: int, d: int, model_rank: int, t: int):
    """Global rank (``data_rank``, ``model_rank``)'s blocks of whole x, w
    and b (or None), as the reference's ``shard_map`` hands them to its
    per-rank ``fused_matmul``: contiguous copies."""
    specs = sharded_specs(x.shape[0], w.shape[2], d, t)
    index, sizes = {"data": data_rank, "model": model_rank}, {"data": d, "model": t}
    return (_cut(x, specs["x"], index, sizes), _cut(w, specs["w"], index, sizes),
            None if b is None else _cut(b, specs["b"], index, sizes))


def assemble(blocks, m: int, f: int, d: int, t: int):
    """The whole (M, T, F) output from the ranks' output blocks in global
    rank order (data index major); a replicated dim takes rank 0's copy."""
    inst, _, mlp = sharded_specs(m, f, d, t)["out"]
    rows = [torch.cat([blocks[di * t + ti] for ti in range(t if mlp else 1)], 2)
            for di in range(d if inst else 1)]
    return torch.cat(rows, 0)
