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

import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

# csrc/fused_matmul.cu's tiles: the FMA / element-wise kernel's blocks
# (64 x 64), the wgmma path's k-step and wide tile rows, the skinny tile's
# columns; variant codes of its C entry point
SIMT_TILE, HK, WIDE_ROWS, SKINNY_COLS = 64, 64, 128, 128
VARIANTS = {"simt": 0, "wide": 1, "skinny": 2}
# fewest k-steps a split of D keeps (a shorter walk would not fill the
# ring); most splits (a cluster of blocks); the skinny split's aim, a
# quarter of the nominal grid's SMs at its instances (``build.NOMINAL_*``)
MIN_SPLIT_STEPS, MAX_SPLIT = 4, 8
SKINNY_TARGET_BLOCKS = build.NOMINAL_SMS // 4
H100_SMS = 132


@dataclass(frozen=True)
class Plan:
    """How one call runs: the kernel variant, its output tile (rows of T x
    columns of F), the split of D's k-steps over the blocks of a cluster,
    and the grid (wide: blocks that walk the tiles)."""
    variant: str
    rows: int
    cols: int
    split: int
    grid: tuple[int, int, int]

    @property
    def code(self) -> int:
        return VARIANTS[self.variant]


def split_ranges(n: int, parts: int) -> list[tuple[int, int]]:
    """The kernels' split of ``n`` steps into ``parts`` contiguous ranges:
    part s covers [s * n // parts, (s + 1) * n // parts)."""
    return [(s * n // parts, (s + 1) * n // parts) for s in range(parts)]


def launch_plan(m: int, t: int, d: int, f: int, dtype: str = "bfloat16",
                sms: int = H100_SMS) -> Plan:
    """The launch of ``csrc/fused_matmul.cu`` for x (m, t, d) @ w (m, d, f).

    f32, and bf16 rows not 16-byte aligned, take the FMA / element-wise
    kernel.  Aligned bf16 takes the wgmma path.  Wide (t > 16): tiles of
    128 rows x 256 columns, or x 128 where the 256-column tiles would
    leave over half the SMs idle, walked by at most ``sms`` blocks.
    Skinny (t <= 16, in a wgmma N of 8 or 16): 128-column tiles; D is
    split over a cluster of blocks (at most ``MAX_SPLIT``, at least
    ``MIN_SPLIT_STEPS`` k-steps each) by :func:`skinny_split`, from d and
    f alone.  (``benchmarks/torch_matmul_sweep.py`` on an H100, device ms:
    a 2x2 rank's block of the serving shape, 44 tiles, 0.0116 whole,
    0.0125 split 2 ways, 0.0158 4 ways; (1, 4, 2048, 1024), 8 tiles,
    0.0109 whole, 0.0067 split 5 ways.)"""
    if dtype != "bfloat16" or d % 8 or f % 8:
        return Plan("simt", SIMT_TILE, SIMT_TILE, 1,
                    (math.ceil(f / SIMT_TILE), math.ceil(t / SIMT_TILE), m))
    if t > 16:
        rows = math.ceil(t / WIDE_ROWS)
        cols = 256 if m * rows * math.ceil(f / 256) >= sms / 2 else 128
        return Plan("wide", WIDE_ROWS, cols, 1, (min(m * rows * math.ceil(f / cols), sms), 1, 1))
    split = skinny_split(d, f)
    return Plan("skinny", 8 if t <= 8 else 16, SKINNY_COLS, split,
                (math.ceil(f / SKINNY_COLS), split, m))


def skinny_split(d: int, f: int) -> int:
    """The skinny path's split of D: the fewest blocks per column tile
    that bring ``build.NOMINAL_INSTANCES`` instances' tiles to
    ``SKINNY_TARGET_BLOCKS``, capped by the cluster and the k-steps.  It
    reads d and f only, never the instance or row count nor the card, so
    a row's sums are added in one order whoever shares its call."""
    tiles, steps = build.NOMINAL_INSTANCES * math.ceil(f / SKINNY_COLS), math.ceil(d / HK)
    return max(1, min(math.ceil(SKINNY_TARGET_BLOCKS / tiles), MAX_SPLIT,
                      steps // MIN_SPLIT_STEPS))


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


class Merged(torch.autograd.Function):
    """The merged matmul under autograd (the MoE experts' products in
    training).  ``forward`` runs ``fwd`` (the kernel's launcher on the
    card, the plain version on the CPU); ``backward`` runs the same
    ``fwd`` on the two merged products of the gradient:

    * dx (M, T, D) = dy (M, T, F) @ w^T (M, F, D), w cast to x's dtype;
    * dw (M, D, F) = x^T (M, D, T) @ dy, returned in w's dtype: the f32
      master's gradient of the cast, as the reference's VJP of
      ``einsum(..., w.astype(x.dtype))`` gives it;
    * db (M, F) = the f32 sum of dy over T, in b's dtype.

    The transposed operands are contiguous copies."""

    @staticmethod
    def forward(ctx, fwd, x, w, b):
        ctx.fwd = fwd
        ctx.save_for_backward(x, w, b)
        return fwd(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[1:]
        dy = _dense(dy, x.dtype)
        dx = dw = db = None
        if need_x:
            dx = ctx.fwd(dy, _dense(w.transpose(1, 2), x.dtype))
        if need_w:
            dw = ctx.fwd(_dense(x.transpose(1, 2), x.dtype), dy).to(w.dtype)
        if need_b:
            db = dy.float().sum(1).to(b.dtype)
        return None, dx, dw, db


def _dense(t, dtype):
    """``t`` as a contiguous tensor of ``dtype``, cast and laid out in one
    copy (``t`` itself where it is one already)."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return torch.empty(t.shape, dtype=dtype, device=t.device).copy_(t)


def fused_matmul_grad(fwd, x, w, b=None):
    """``fwd`` (same contract as the plain version) under :class:`Merged`."""
    _check(x, w, b)
    return Merged.apply(fwd, x, w, b)


def fused_matmul_cuda(x, w, b=None):
    """The Hopper kernel: same contract as the plain version; x and w
    contiguous CUDA tensors of float32 or bfloat16 (w is cast to x's dtype
    first where it differs), any shape; launched as :func:`launch_plan`
    says (one wrapper call, one kernel launch)."""
    _check(x, w, b)
    m, t, d = x.shape
    w = w.to(x.dtype)
    return launch(x, w, b, launch_plan(m, t, d, w.shape[2], str(x.dtype).removeprefix("torch."),
                                       build.sm_count(x.device)))


def launch(x, w, b, plan: Plan):
    """``csrc/fused_matmul.cu`` on x and w of one dtype as ``plan`` says (a
    plan of :func:`launch_plan`, or one with another split of D); the
    kernel checks the plan against the shapes."""
    _check(x, w, b)
    for name, a in (("x", x), ("w", w)):
        if not a.is_cuda or not a.is_contiguous() or a.data_ptr() % 16 or a.dtype != x.dtype:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned CUDA tensor "
                             f"of {x.dtype}")
    m, t, d = x.shape
    f = w.shape[2]
    bias = None if b is None else b.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty(m, t, f, dtype=x.dtype, device=x.device)
    fn = build.entry("fused_matmul", "fused_matmul", "ipppppiiiiiiiip")
    P = build.ptr
    # w's tensor map, encoded once per weight (the x map changes every call)
    wmap = build.tensor_maps.get(w, HK) if plan.variant != "simt" else None
    build.check(fn(build.dtype_code(x), P(x), P(w), wmap, P(bias), P(out), m, t, d, f,
                   plan.code, plan.cols, plan.grid[0], plan.split, build.stream_ptr(x)),
                "fused_matmul")
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
