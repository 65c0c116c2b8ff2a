"""Achieved-vs-roofline profiling of the port's kernels (port of
``repro.serving.obs.kernel_profile``).

Times each kernel at the shapes a config's serving (or the paper's
evaluation) launches it with, through the wrappers of ``kernels/ops.py``
(so their launch counters show what ran), and reports achieved FLOP/s and
bytes/s against the roofline of one NVIDIA H100.  On the card a kernel is
timed with CUDA events, the minimum of ``repeats`` calls after a warm-up;
on the CPU the wrappers run the plain PyTorch versions, timed with the
host clock.  Every record carries ``backend``, the device name and
``plain`` (true on the CPU), so a CPU row can never pass for a card row.

FLOP and byte models are first order and dense-equivalent (masked
attention positions count), as in the reference: a roofline tool, not a
cycle simulator.
"""
from __future__ import annotations

import math
import time

import torch

from repro_torch.kernels import ops

# NVIDIA H100 SXM, published dense peaks (data sheet): HBM bytes/s and
# FLOP/s by operand dtype.  chip_smoke.py reads them from here.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# the reference's serving kernels, in its order
KERNELS = ("fused_matmul", "decode_attn", "chunk_prefill_attn",
           "mlstm_chunk", "slstm_cell", "decode_layer", "logits_sample")


def _nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def serving_shapes(cfg, *, slots: int = 4, max_context: int = 128,
                   chunk: int = 32, prefill_lanes: int = 4) -> dict:
    """Kernel input geometry at this config's serving shapes (the
    reference's): M from the merged instance count, B from the grid slots,
    S from the serving context, C from the prefill chunk."""
    m = max(cfg.num_instances, 1)
    hd = cfg.head_dim
    # recurrent families project to an inner width (ssm.d_inner); attention
    # families have no mlstm/slstm path but still get well-formed shapes
    di = int((cfg.mlstm_proj_factor or 2.0) * cfg.d_model)
    return {
        "fused_matmul": dict(m=m, t=slots, d=cfg.d_model, f=cfg.d_ff or 4 * cfg.d_model),
        "decode_attn": dict(m=m, b=slots, h=cfg.num_heads, kvh=cfg.num_kv_heads, hd=hd,
                            s=max_context),
        "chunk_prefill_attn": dict(m=m, b=prefill_lanes, c=chunk, h=cfg.num_heads,
                                   kvh=cfg.num_kv_heads, hd=hd, s_cache=max_context - chunk),
        "mlstm_chunk": dict(m=m, b=prefill_lanes, h=cfg.num_heads, s=chunk,
                            hd=di // cfg.num_heads, chunk=min(cfg.mlstm_chunk or 64, chunk)),
        "slstm_cell": dict(m=m, b=prefill_lanes, s=chunk, d=di, h=cfg.num_heads),
        "decode_layer": dict(m=m, b=slots, d=cfg.d_model, h=cfg.num_heads,
                             kvh=cfg.num_kv_heads, hd=hd, s=max_context,
                             ff=cfg.d_ff or 4 * cfg.d_model, window=cfg.sliding_window or 0),
        "logits_sample": dict(m=m, b=slots, d=cfg.d_model, v=cfg.vocab_size),
    }


def paper_shapes(cfg, *, batch: int = 1, seq_len: int = 128) -> dict:
    """The paper-evaluation geometry of an encoder config: the merged
    matmul of its MLP and the per-instance RMS norm of its rows, at
    T = batch * seq_len rows per instance."""
    m, t = max(cfg.num_instances, 1), batch * seq_len
    return {"fused_matmul": dict(m=m, t=t, d=cfg.d_model, f=cfg.d_ff or 4 * cfg.d_model),
            "group_rms_norm": dict(m=m, t=t, d=cfg.d_model)}


# -- per-kernel builders: (callable, flops, bytes, shape string) -------------


def _mk_fused_matmul(m, t, d, f, dt, dev):
    x = torch.ones(m, t, d, dtype=dt, device=dev)
    w = torch.ones(m, d, f, dtype=dt, device=dev)
    return (lambda: ops.fused_matmul(x, w), 2.0 * m * t * d * f,
            _nbytes(x, w) + m * t * f * x.element_size(), f"({m},{t},{d})@({m},{d},{f})")


def _mk_group_rms_norm(m, t, d, dt, dev):
    x = torch.ones(m, t, d, dtype=dt, device=dev)
    scale = torch.ones(m, d, dtype=dt, device=dev)
    return (lambda: ops.group_rms_norm(x, scale), 4.0 * m * t * d,
            _nbytes(x, scale) + x.numel() * x.element_size(), f"x({m},{t},{d})")


def _mk_decode_attn(m, b, h, kvh, hd, s, dt, dev):
    q = torch.ones(m, b, h, hd, dtype=dt, device=dev)
    k = torch.ones(m, b, s, kvh, hd, dtype=dt, device=dev)
    v = torch.ones(m, b, s, kvh, hd, dtype=dt, device=dev)
    kv_len = torch.full((m, b), s, dtype=torch.int32, device=dev)
    return (lambda: ops.decode_attention(q, k, v, kv_len), 4.0 * m * b * h * s * hd,
            _nbytes(q, k, v) + _nbytes(q), f"q({m},{b},{h},{hd}) kv S={s}")


def _mk_chunk_prefill_attn(m, b, c, h, kvh, hd, s_cache, dt, dev):
    t = s_cache + c
    q = torch.ones(m, b, c, h, hd, dtype=dt, device=dev)
    k = torch.ones(m, b, t, kvh, hd, dtype=dt, device=dev)
    v = torch.ones(m, b, t, kvh, hd, dtype=dt, device=dev)
    offset = torch.full((m, b), s_cache, dtype=torch.int32, device=dev)
    return (lambda: ops.chunk_prefill_attention(q, k, v, offset, s_cache=s_cache),
            4.0 * m * b * c * h * t * hd,             # dense-equivalent
            _nbytes(q, k, v) + _nbytes(q), f"q({m},{b},{c},{h},{hd}) cache S={s_cache}")


def mlstm_chunkwise_flops(lanes: int, s: int, hd: int, chunk: int) -> float:
    """FLOPs the chunkwise mLSTM needs from the zero state over s steps:
    per chunk of cs steps the scores q k^T and their product with v
    (4 cs^2 hd) and the state update k^T v (2 cs hd^2); every chunk after
    the first also reads the carried state, q C (2 cs hd^2), and decays it
    (hd^2).  The first chunk's q C and decay act on C = 0 and are not
    counted."""
    cs = min(chunk, s)
    later = -(-s // cs) - 1
    return lanes * (s * (4.0 * cs * hd + 2.0 * hd * hd) + later * (2.0 * cs + 1.0) * hd * hd)


def _mk_mlstm_chunk(m, b, h, s, hd, chunk, dt, dev):
    q = torch.ones(m, b, h, s, hd, dtype=dt, device=dev)
    k = torch.ones(m, b, h, s, hd, dtype=dt, device=dev)
    v = torch.ones(m, b, h, s, hd, dtype=dt, device=dev)
    lf = torch.zeros(m, b, h, s, dtype=torch.float32, device=dev)
    li = torch.zeros(m, b, h, s, dtype=torch.float32, device=dev)
    cs = min(chunk, s)
    return (lambda: ops.mlstm_chunkwise(q, k, v, lf, li, chunk=cs),
            mlstm_chunkwise_flops(m * b * h, s, hd, cs),
            _nbytes(q, k, v, lf, li) + _nbytes(q) + m * b * h * (hd * hd + hd + 1) * 4,
            f"qkv({m},{b},{h},{s},{hd}) chunk={cs}")


def _mk_slstm_cell(m, b, s, d, h, dt, dev):
    hd = d // h
    pre = torch.ones(m, b, s, 4, d, dtype=dt, device=dev)
    r = torch.ones(m, 4, h, hd, hd, dtype=dt, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    state = (torch.zeros(m, b, d, **f32), torch.zeros(m, b, d, **f32),
             torch.zeros(m, b, d, dtype=dt, device=dev), torch.zeros(m, b, d, **f32))
    # per step: 4 recurrent head matmuls (8 H hd^2) + ~16 D elementwise
    return (lambda: ops.slstm_cell(pre, r, state, num_heads=h),
            m * b * s * (8.0 * h * hd * hd + 16.0 * d),
            _nbytes(pre, r) + m * b * s * d * pre.element_size(), f"pre({m},{b},{s},4,{d}) H={h}")


def _mk_decode_layer(m, b, d, h, kvh, hd, s, ff, window, dt, dev):
    o = dict(dtype=dt, device=dev)
    lp = {
        "attn_norm": torch.ones(m, d, **o), "mlp_norm": torch.ones(m, d, **o),
        "wq": torch.ones(m, d, h * hd, **o), "wk": torch.ones(m, d, kvh * hd, **o),
        "wv": torch.ones(m, d, kvh * hd, **o), "wo": torch.ones(m, h * hd, d, **o),
        "w_gate": torch.ones(m, d, ff, **o), "w_up": torch.ones(m, d, ff, **o),
        "w_down": torch.ones(m, ff, d, **o),
    }
    x = torch.ones(m, b, d, **o)
    ck = torch.zeros(m, b, s, kvh, hd, **o)
    cv = torch.zeros(m, b, s, kvh, hd, **o)
    pos = torch.full((m, b), s - 1, dtype=torch.int32, device=dev)
    # per lane: qkv proj + attention over the full ring + out proj + swiglu
    flops = m * b * (2.0 * d * (h + 2 * kvh) * hd + 4.0 * h * hd * s
                     + 2.0 * h * hd * d + 6.0 * d * ff)
    return (lambda: ops.decode_layer(lp, x, ck, cv, pos, num_heads=h, head_dim=hd,
                                     rope_theta=10000.0, window=window),
            flops, _nbytes(x, ck, cv, pos, *lp.values()) + _nbytes(x, ck, cv),
            f"x({m},{b},{d}) H={h}/{kvh} S={s} ff={ff}")


def _mk_logits_sample(m, b, d, v, dt, dev):
    x = torch.ones(m, b, d, dtype=dt, device=dev)
    scale = torch.ones(m, d, dtype=dt, device=dev)
    head = torch.ones(m, d, v, dtype=dt, device=dev)
    return (lambda: ops.logits_sample(x, scale, head), 2.0 * m * b * d * v,
            _nbytes(x, scale, head) + m * b * 4, f"x({m},{b},{d}) V={v}")


_BUILDERS = {
    "fused_matmul": _mk_fused_matmul,
    "group_rms_norm": _mk_group_rms_norm,
    "decode_attn": _mk_decode_attn,
    "chunk_prefill_attn": _mk_chunk_prefill_attn,
    "mlstm_chunk": _mk_mlstm_chunk,
    "slstm_cell": _mk_slstm_cell,
    "decode_layer": _mk_decode_layer,
    "logits_sample": _mk_logits_sample,
}


def _time_s(fn, dev: torch.device, repeats: int) -> float:
    """Minimum seconds of ``repeats`` calls after a warm-up call: CUDA
    events on the card, the host clock around a plain call on the CPU."""
    fn()
    best = math.inf
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(max(repeats, 1)):
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def profile_kernel(name: str, *, dtype: str = "bfloat16", repeats: int = 3, device="cuda",
                   **shape) -> dict:
    """Time one kernel at the given shape; achieved FLOP/s and bytes/s
    against the H100 roofline for ``dtype``."""
    dev = torch.device(device)
    fn, flops, nbytes, shape_str = _BUILDERS[name](**shape, dt=getattr(torch, dtype), dev=dev)
    wall = _time_s(fn, dev, repeats)
    peak = PEAK_FLOPS[dtype]
    t_compute, t_memory = flops / peak, nbytes / HBM_BYTES_PER_S
    roofline_flops = flops / max(t_compute, t_memory)
    achieved_flops = flops / wall
    return {
        "kernel": name,
        "shape": shape_str,
        "dtype": dtype,
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "plain": dev.type != "cuda",
        "wall_s": wall,
        "flops": flops,
        "bytes": nbytes,
        "intensity": flops / nbytes,
        "achieved_flops_per_s": achieved_flops,
        "achieved_bytes_per_s": nbytes / wall,
        "roofline_flops_per_s": roofline_flops,
        "bound_s": max(t_compute, t_memory),
        "frac_of_roofline": achieved_flops / roofline_flops,
        "bound": "compute" if t_compute >= t_memory else "memory",
    }


def profile_serving_kernels(cfg, *, slots: int = 4, max_context: int = 128, chunk: int = 32,
                            prefill_lanes: int = 4, repeats: int = 3, kernels=KERNELS,
                            device="cuda") -> list[dict]:
    """Profile each of ``kernels`` at this config's serving shapes (the
    grid and admission geometry the engine launches)."""
    shapes = serving_shapes(cfg, slots=slots, max_context=max_context, chunk=chunk,
                            prefill_lanes=prefill_lanes)
    return [profile_kernel(k, dtype=cfg.dtype, repeats=repeats, device=device, **shapes[k])
            for k in kernels]


def format_table(rows) -> str:
    """Markdown achieved-vs-roofline table."""
    out = [
        "| kernel | shape | wall (ms) | bound (ms) | GFLOP/s | GB/s | % roofline | bound "
        "| backend |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        be = f"{r['backend']} ({r['device']})" + (" plain" if r["plain"] else "")
        out.append(
            f"| {r['kernel']} | {r['shape']} | {1e3 * r['wall_s']:.4f} "
            f"| {1e3 * r['bound_s']:.4f} "
            f"| {r['achieved_flops_per_s'] / 1e9:.2f} "
            f"| {r['achieved_bytes_per_s'] / 1e9:.2f} "
            f"| {100 * r['frac_of_roofline']:.2f}% | {r['bound']} | {be} |")
    return "\n".join(out)


def validate_profile(rows) -> None:
    """Every figure finite and positive; every row says where it ran."""
    for r in rows:
        for f in ("wall_s", "flops", "bytes", "achieved_flops_per_s", "achieved_bytes_per_s",
                  "roofline_flops_per_s", "frac_of_roofline", "bound_s"):
            v = r[f]
            assert isinstance(v, (int, float)) and math.isfinite(v) and v > 0, (
                r["kernel"], f, v)
        assert r["backend"] in ("cuda", "cpu"), r
        assert r["plain"] == (r["backend"] == "cpu"), r
