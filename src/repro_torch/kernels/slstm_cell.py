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
serving K-step block freezes a stopped lane that way.  ``rows`` (M,)
int32, when given, names the instance of r that each row of ``pre``
reads (r then holds the merged model's instances, not one per row): a
prefill chunk's lanes read their instances' weights in place.

:func:`launch_plan` decides where the kernel keeps r during a call: in
registers, in shared memory, or streamed from L2 every step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

# CTAs of one thread-block cluster, which owns one (instance, head): 8, the
# portable size, or 16 where that holds a prefill's r whole on chip; a
# CTA's 256 consumer threads split 4 x hd/cluster gate columns into float4
# quads (and a producer warp feeds the ring of streamed rows)
CLUSTER = 8
CLUSTER_WIDE = 16
_THREADS = 256
H100_SMS = 132
# csrc/slstm_cell.cu: largest dynamic shared memory of a block; the most
# register rows a thread holds (28 float4 quads of f32, 48 of bf16: 112
# and 96 registers, under the 168 that a 9-warp block leaves a thread
# with the rest of the kernel's); the ring's stages (a TMA box per gate)
# and depth: 3 of 16 KB where rows stream from L2 every step (each stage
# costs resident rows), 2 of 32 KB for decode's one pass from HBM (a
# block under half an SM's shared memory: two to an SM, so all clusters
# of a serve shape are resident at once; benchmarks/torch_slstm_sweep.py
# times the others)
MAX_SMEM = 232448
NRR_MAX = {8: {"float32": 28, "bfloat16": 48}, 16: {"float32": 16, "bfloat16": 24}}
STAGE_BYTES = {"l2": 16384, "hbm": 32768}
STAGES = {"l2": 3, "hbm": 2}


@dataclass(frozen=True)
class CellPlan:
    """Where a call keeps r (per CTA, rows of its 4 x hd/cluster slice):
    rows [0, reg_rows) in registers (``nrr`` per thread), the next
    ``smem_rows`` in shared memory, the last ``stream_rows`` streamed each
    step in stages of ``stage_rows`` through a ring of ``stages``; ``lanes``
    lanes per pass of the recurrent product."""
    grid: tuple[int]
    cluster: int
    lanes: int
    nrr: int
    reg_rows: int
    smem_rows: int
    stream_rows: int
    stage_rows: int
    stages: int
    smem_bytes: int
    stream_bytes_per_step: int


def _round128(b: int) -> int:
    return -(-b // 128) * 128


def smem_bytes(b: int, hd: int, rsz: int, lanes: int, ks: int, sr: int, stages: int,
               cluster: int = CLUSTER) -> int:
    """csrc/slstm_cell.cu's ``smem_bytes``: the dynamic shared memory of
    a launch."""
    cw = hd // cluster
    kg, rowb = _THREADS // cw, 4 * cw * rsz
    return (128 + _round128(16 * stages) + _round128(stages * sr * rowb) + _round128(ks * rowb)
            + _round128(2 * b * hd * 4) + _round128(kg * lanes * 4 * cw * 4) + 3 * b * cw * 4)


def launch_plan(m: int, b: int, s: int, h: int, hd: int, r_dtype: str = "float32",
                sms: int = H100_SMS) -> CellPlan:
    """The launch of ``csrc/slstm_cell.cu`` for ``m`` rows of ``b`` lanes,
    ``s`` steps, ``h`` heads of ``hd``, r in ``r_dtype``.

    A CTA's slice of r is 4 x hd/cluster columns over hd rows.  Where it
    fits in shared memory beside the state, it is loaded there once.
    Decode (s = 1) reads r once, so it streams every row through a deep
    ring at the HBM rate.  A prefill chunk (s > 1) re-reads r every step,
    so it keeps it on chip: the first rows in registers (each thread's
    fixed quads), the next in shared memory.  Where a cluster of 8 cannot
    hold it all, one of 16 (twice the SMs per (row, head), fewer clusters
    resident at once) holds it whole if it can; else the rows left over
    stream each step, from L2.  ``sms`` sizes nothing: one cluster per
    (row, head) either way."""
    if hd % (4 * CLUSTER) or hd // CLUSTER > _THREADS:
        raise ValueError(f"the kernel takes head_dim a multiple of {4 * CLUSTER} "
                         f"up to {CLUSTER * _THREADS}, not {hd}")
    rsz = 4 if r_dtype == "float32" else 2
    lanes = 1 if b == 1 else 4

    def fit(cl):
        """(nrr, rows left after registers, shared memory free) at cl."""
        cw = hd // cl
        kg = _THREADS // cw
        avail = MAX_SMEM - smem_bytes(b, hd, rsz, lanes, 0, 0, 1, cl)
        nrr = min(NRR_MAX[cl][r_dtype], hd // kg) if s > 1 and _THREADS % cw == 0 else 0
        return cw, kg, nrr, hd - kg * nrr, avail

    cl = CLUSTER
    cw, kg, nrr, rest, avail = fit(cl)
    rowb = 4 * cw * rsz
    if s > 1 and rest * rowb > avail and hd % (4 * CLUSTER_WIDE) == 0:
        cw16, kg16, nrr16, rest16, avail16 = fit(CLUSTER_WIDE)
        if rest16 * 4 * cw16 * rsz <= avail16:
            cl, cw, kg, nrr, rest, avail = CLUSTER_WIDE, cw16, kg16, nrr16, rest16, avail16
            rowb = 4 * cw * rsz
    ks, sr, stages = hd, 0, 1
    if hd * rowb <= avail:
        nrr, rest = 0, hd
    elif s > 1 and rest * rowb <= avail:
        ks = rest
    else:
        if (cw * rsz) % 16:
            raise ValueError(f"r's slice of {hd} rows does not fit, and its rows are not "
                             "16-byte pieces to stream")
        if s == 1:
            nrr, rest = 0, hd
        # a stage's box per gate: at most 256 rows, 128-byte aligned
        src = "hbm" if s == 1 else "l2"
        align = 128 // math.gcd(128, cw * rsz)
        sr = min(256, STAGE_BYTES[src] // rowb) // align * align
        stages = STAGES[src]
        ring = (smem_bytes(b, hd, rsz, lanes, 0, sr, stages, cl)
                - smem_bytes(b, hd, rsz, lanes, 0, 0, 1, cl))
        ks = 0 if s == 1 else min(rest, max(0, (avail - ring - 128) // rowb))
    kr = kg * nrr
    ns = hd - kr - ks
    smem = smem_bytes(b, hd, rsz, lanes, ks, sr, stages, cl)
    assert smem <= MAX_SMEM, (m, b, s, h, hd, smem)
    return CellPlan(grid=(m * h * cl,), cluster=cl, lanes=lanes, nrr=nrr,
                    reg_rows=kr, smem_rows=ks, stream_rows=ns, stage_rows=sr, stages=stages,
                    smem_bytes=smem,
                    stream_bytes_per_step=m * h * cl * ns * rowb * math.ceil(b / lanes))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, max=0.0) - torch.log1p(torch.exp(-x.abs()))


def slstm_scan(pre, r, state, num_heads: int):
    """The reference's sLSTM training math (``repro/models/ssm.py``,
    ``slstm_block``'s step scan): pre (M, B, S, 4, D) upcast per step, r
    (M, 4, H, hd, hd) in f32, state (c, n, h, m) each (M, B, D) with c, n,
    m in f32 and h in its storage dtype, to which each step's h is
    rounded.  Functional (nothing in place), so autograd differentiates
    it.  Returns (hs (M, B, S, D) in h's dtype, the final state)."""
    m, b, s, _, d = pre.shape
    hd = d // num_heads
    c, n, h, mst = state
    c, n, mst, rf = c.float(), n.float(), mst.float(), r.float()
    hs = []
    for t in range(s):
        rec = torch.einsum("mbhd,mghde->mbghe", h.float().reshape(m, b, num_heads, hd),
                           rf).reshape(m, b, 4, d)
        pre_t = pre[:, :, t].float()
        zt, it, ft, ot = (pre_t[:, :, j] + rec[:, :, j] for j in range(4))
        lf = log_sigmoid(ft)
        mt = torch.maximum(lf + mst, it)
        fp = torch.exp(lf + mst - mt)
        ip = torch.exp(it - mt)
        c = fp * c + ip * torch.tanh(zt)
        n = fp * n + ip
        h = (torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)).to(h.dtype)
        mst = mt
        hs.append(h)
    return torch.stack(hs, dim=2), (c, n, h, mst)


def _check_shapes(pre, r, state, num_heads, rows=None):
    m, b, s, four, d = pre.shape
    if four != 4 or d % num_heads:
        raise ValueError(f"pre must be (M, B, S, 4, D) with D % H == 0, got {tuple(pre.shape)}")
    hd = d // num_heads
    m_r = m if rows is None else r.shape[0]
    if tuple(r.shape) != (m_r, 4, num_heads, hd, hd):
        raise ValueError(f"r must be {(m_r, 4, num_heads, hd, hd)}, got {tuple(r.shape)}")
    if rows is not None and (rows.dtype != torch.int32 or tuple(rows.shape) != (m,)):
        raise TypeError(f"rows must be an int32 ({m},) tensor")
    for name, t in zip("cnhm", state):
        if tuple(t.shape) != (m, b, d):
            raise ValueError(f"state {name} must be {(m, b, d)}, got {tuple(t.shape)}")
    return m, b, s, d, hd


def slstm_cell_plain(pre, r, state, *, num_heads: int, alive=None, rows=None):
    """pre (M, B, S, 4, D) gate pre-activations; r (M, 4, H, hd, hd), or
    (M_r, 4, H, hd, hd) with ``rows`` (M,) int32 naming each row's
    instance; state (c, n, h, m) each (M, B, D): c/n/m f32, h in its
    storage dtype, updated in place.  Returns (hs (M, B, S, D) in h's
    dtype, state).  The scan is :func:`slstm_scan`."""
    _check_shapes(pre, r, state, num_heads, rows)
    rr = r if rows is None else r.index_select(0, rows.long())
    hs, new = slstm_scan(pre, rr, state, num_heads)
    keep = None if alive is None else alive[..., None]
    for dst, t in zip(state, new):
        dst.copy_(t if keep is None else torch.where(keep, t.to(dst.dtype), dst))
    return hs, state


class Scan(torch.autograd.Function):
    """The sLSTM scan under autograd.

    ``forward`` runs ``fwd`` (the kernel's launcher on the card; a test
    may pass the plain version) into freshly allocated copies of the
    initial state, which it returns.  ``backward`` recomputes the
    reference's training math (:func:`slstm_scan`, the step scan
    with h rounded to its dtype each step) and differentiates it; no
    backward kernel is written, as the reference has none.  Gradients
    reach pre, r and the initial state."""

    @staticmethod
    def forward(ctx, fwd, num_heads, pre, r, c, n, h, m):
        ctx.set_materialize_grads(False)
        ctx.num_heads = num_heads
        ctx.save_for_backward(pre, r, c, n, h, m)
        state = tuple(t.clone(memory_format=torch.contiguous_format) for t in (c, n, h, m))
        hs, _ = fwd(pre, r, state, num_heads=num_heads)
        return (hs,) + state

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[2:]
        ins = [t.detach().requires_grad_(q) for t, q in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            hs, state = slstm_scan(ins[0], ins[1], tuple(ins[2:]), ctx.num_heads)
            pairs = [(o, g) for o, g in zip((hs,) + state, grads) if g is not None]
            wrt = [t for t, q in zip(ins, need) if q]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                           allow_unused=True) if pairs and wrt else ())
        return (None, None) + tuple(next(got, None) if q else None for q in need)


def slstm_cell_grad(fwd, pre, r, state, *, num_heads: int, alive=None, rows=None):
    """``fwd`` (same contract as the plain version) under :class:`Scan`:
    the initial state is not written; the new state comes back as new
    tensors.  Training has no frozen lanes and no per-lane instances, so
    ``alive`` and ``rows`` are refused."""
    if alive is not None or rows is not None:
        raise NotImplementedError("slstm_cell under autograd takes no alive / rows")
    _check_shapes(pre, r, state, num_heads)
    hs, *new = Scan.apply(fwd, num_heads, pre, r, *state)
    return hs, tuple(new)


def slstm_cell_cuda(pre, r, state, *, num_heads: int, alive=None, rows=None):
    """The Hopper kernel: one launch scans all S steps; one cluster of
    CTAs per (row, head) exchanges h through distributed shared memory
    each step and keeps r on chip as :func:`launch_plan` says.  Same
    contract as the plain version."""
    m, b, s, d, hd = _check_shapes(pre, r, state, num_heads, rows)
    return launch(pre, r, state, num_heads, alive, rows,
                  launch_plan(m, b, s, num_heads, hd, str(r.dtype).removeprefix("torch.")))


def launch(pre, r, state, num_heads: int, alive, rows, plan: CellPlan):
    """``csrc/slstm_cell.cu`` as ``plan`` says (a plan of
    :func:`launch_plan`, or one with another ring); the kernel checks the
    plan against the shapes."""
    m, b, s, d, hd = _check_shapes(pre, r, state, num_heads, rows)
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
    if rows is not None and (not rows.is_cuda or not rows.is_contiguous()):
        raise ValueError("rows must be a contiguous CUDA tensor")
    p = plan
    hs = torch.empty((m, b, s, d), dtype=h.dtype, device=pre.device)
    # r as (M_r * 4 * H) planes of hd x hd, read in boxes of the stage's
    # rows by a CTA's columns; encoded once per weight
    rmap = (build.tensor_maps.get(r.view(-1, hd, hd), p.stage_rows, "slstm_cell",
                                  b0=hd // p.cluster, swizzle=False) if p.stream_rows else None)
    fn = build.entry("slstm_cell", "slstm_cell", "ii" + "p" * 10 + "i" * 12 + "p")
    P = build.ptr
    build.check(fn(build.dtype_code(pre), build.dtype_code(r), rmap, P(pre), P(r), P(rows), P(c),
                   P(n), P(h), P(mst), P(alive), P(hs), m, b, s, num_heads, hd, p.cluster, p.nrr,
                   p.reg_rows, p.smem_rows, p.stage_rows, p.stages, p.lanes,
                   build.stream_ptr(pre)), "slstm_cell")
    return hs, state


def max_active_clusters(plan: CellPlan, b: int, hd: int, dtype: str, r_dtype: str) -> int:
    """How many of the plan's clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``): at most this many (row, head)
    units run together, the rest in later waves."""
    codes = build.DTYPE_CODES
    return build.entry("slstm_cell", "slstm_cell_max_clusters", "i" * 11)(
        codes[dtype], codes[r_dtype], b, hd, plan.cluster, plan.nrr, plan.lanes, plan.reg_rows,
        plan.smem_rows, plan.stage_rows, plan.stages)
