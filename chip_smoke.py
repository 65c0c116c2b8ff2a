#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

  python3 chip_smoke.py

Phases, each printing one line of findings (any failure exits non-zero
before the result line is printed):

1. device  -- the card's name and power limit (nvidia-smi);
2. build   -- compile every kernel of ``src/repro_torch/csrc`` with nvcc,
              one process per source, and print ptxas registers / spills;
3. kernels -- each Hopper kernel against its plain PyTorch version: the
              dense kernels at the tinyllama-1.1b width (M=4, B=4, S=1024,
              C=32, D=2048, H=32, KVH=4, hd=64, F=5632, V=32000), the sLSTM
              cell at the xlstm-1.3b width (M=4, B=4, D=2048, H=4, hd=512,
              S=1 and 32), and at the hymba-1.5b width (H=25, KVH=5, hd=64)
              the decode attention (S=1536, mixed kv_len), the chunk
              attention at both of its geometries (SWA ring: S=1152,
              pin=128, window=1024, sink=128; global: S=1536,
              window=1<<30) and the logits at D=1600, V=32001, in bf16 and
              f32;
4. serve   -- three main paths, each with every launch counter set to 0
              just before it and read just after: ``MultiModelServer`` on
              the full tinyllama-1.1b config (dense: decode layer, chunk
              attention, logits), on the full xlstm-1.3b config (ssm:
              sLSTM cell, logits) and on the full hymba-1.5b config
              (hybrid: chunk attention, decode attention of the 3 global
              layers, logits; max_context 1536), M=4 seeded random
              instances, 16 requests each; every kernel of a path must
              have launched;
5. check   -- greedy K=1 vs K=8 streams identical on the card for the
              three families (full widths, cut depth), and the kernel
              path against the plain path on the CPU on small f32
              configs (hymba-smoke at 4 layers over 176 prefilled
              positions: the meta prefix and a wrapped SWA ring);
6. times   -- each kernel, its plain version and (for chunk and decode
              attention) ``scaled_dot_product_attention`` timed with CUDA
              events at the serving shapes, beside the bound from bytes
              and FLOPs.

The line before the last is the per-kernel JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# the full-width shapes of tinyllama-1.1b at M=4 instances, 4 slots each
M, B, S, C = 4, 4, 1024, 32
D, H, KVH, HD, F, V = 2048, 32, 4, 64, 5632, 32000
# the sLSTM cell of xlstm-1.3b: D=2048 over 4 heads
XH, XHD = 4, 512
# hymba-1.5b: 25 heads over 5 kv heads of 64, d 1600, vocab 32001; the
# serving context holds the 128 meta tokens, the 1024-slot SWA window and
# prompts of up to 512 tokens with 32 new ones
YH, YKVH, YD, YV, YS = 25, 5, 1600, 32001, 1536
YSWA = 128 + 1024

# bf16 tolerance, relative to the largest magnitude of the plain output:
# one bf16 ulp is 2^-8 = 3.9e-3; the kernels sum in another order than
# cuBLAS / torch, which can flip the rounding of an intermediate stored in
# bf16 (q, k, v, the attention output, the SwiGLU hidden) and later stages
# carry that on.  f32: summation order only.
TOL = {"bfloat16": 3e-2, "float32": 1e-4}


def log(phase, **kw):
    print(f"[{phase}] " + ", ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp(min=1.0)).item()


def abs_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def bound_ms(nbytes, flops, dtype):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def layer_inputs(torch, dev, dt, seed, bias=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shp, sc=1.0: torch.randn(shp, generator=g, device=dev) * sc
    lp = {
        "attn_norm": 1 + 0.1 * r(M, D), "mlp_norm": 1 + 0.1 * r(M, D),
        "wq": r(M, D, H * HD, sc=D ** -0.5).to(dt), "wk": r(M, D, KVH * HD, sc=D ** -0.5).to(dt),
        "wv": r(M, D, KVH * HD, sc=D ** -0.5).to(dt),
        "wo": r(M, H * HD, D, sc=(H * HD) ** -0.5).to(dt),
        "w_gate": r(M, D, F, sc=D ** -0.5).to(dt), "w_up": r(M, D, F, sc=D ** -0.5).to(dt),
        "w_down": r(M, F, D, sc=F ** -0.5).to(dt),
    }
    if bias:
        lp.update(bq=r(M, H * HD, sc=0.1).to(dt), bk=r(M, KVH * HD, sc=0.1).to(dt),
                  bv=r(M, KVH * HD, sc=0.1).to(dt))
    x = r(M, B, D).to(dt)
    ck, cv = r(M, B, S, KVH, HD).to(dt), r(M, B, S, KVH, HD).to(dt)
    return lp, x, ck, cv


def chunk_inputs(torch, dev, dt, seed, m, b, offsets, s=None, h=None, kvh=None):
    """q (m,b,C,h,hd), k/v (m,b,s+C,kvh,hd) (default: the tinyllama width
    S, H, KVH) and the lanes' offsets."""
    s, h, kvh = s or S, h or H, kvh or KVH
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(m, b, C, h, HD, generator=g, device=dev).to(dt)
    k = torch.randn(m, b, s + C, kvh, HD, generator=g, device=dev).to(dt)
    v = torch.randn(m, b, s + C, kvh, HD, generator=g, device=dev).to(dt)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev).reshape(m, b)
    return q, k, v, off


def logits_inputs(torch, dev, xdt, seed, dup=True, d=None, v=None):
    """x (M,B,d), scale (M,d), f32 head (M,d,v) (default: the tinyllama
    width D, V).  With ``dup``, one column is made the clear winner for
    every lane and copied to an earlier and a later index: the answer must
    be the earlier copy, bit-exactly tied."""
    d, v = d or D, v or V
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, B, d, generator=g, device=dev).to(xdt)
    scale = 1 + 0.1 * torch.randn(M, d, generator=g, device=dev)
    head = torch.randn(M, d, v, generator=g, device=dev) * d ** -0.5
    if dup:
        xf = x.float()
        n = xf / xf.pow(2).mean(-1, keepdim=True).add(1e-5).sqrt() * scale[:, None]
        win = n.sum(1) / (B * d ** 0.5)
        for col in (v - 1000, 5, v - 1):
            head[:, :, col] = win
    return x, scale, head


def decode_attn_inputs(torch, dev, dt, seed, lens=None):
    """q (M,B,25,64), k/v (M,B,1536,5,64) at the hymba-1.5b width and
    kv_len (M,B): the edges 1, 128 (one split), 129, 1536 and random
    lengths, unless ``lens`` gives its own range [lo, hi)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(M, B, YH, HD, generator=g, device=dev).to(dt)
    k = torch.randn(M, B, YS, YKVH, HD, generator=g, device=dev).to(dt)
    v = torch.randn(M, B, YS, YKVH, HD, generator=g, device=dev).to(dt)
    lo, hi = lens or (1, YS + 1)
    kv_len = torch.randint(lo, hi, (M, B), generator=g, device=dev, dtype=torch.int32)
    if lens is None:
        kv_len.view(-1)[:4] = torch.tensor([1, 128, 129, YS], dtype=torch.int32)
    return q, k, v, kv_len


def slstm_inputs(torch, dev, dt, rdt, m, b, s, seed, junk=False):
    """Gate pre-activations (M,B,S,4,D), recurrent weights (M,4,H,hd,hd)
    and a non-zero carried state at the xlstm-1.3b cell width.  With
    ``junk``, lanes end early as in a padded final prefill chunk: their
    suffix takes the neutral gates (input -1e30, forget +1e30)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    d = XH * XHD
    pre = torch.randn(m, b, s, 4, d, generator=g, device=dev)
    if junk:
        neutral = torch.tensor([0.0, -1e30, 1e30, 0.0], device=dev)[:, None]
        ends = torch.randint(0, s, (m, b), generator=g, device=dev)
        for mi in range(m):
            for bi in range(b):
                pre[mi, bi, int(ends[mi, bi]):] = neutral
    r = (torch.randn(m, 4, XH, XHD, XHD, generator=g, device=dev) * XHD ** -0.5).to(rdt)
    state = (torch.randn(m, b, d, generator=g, device=dev),
             torch.rand(m, b, d, generator=g, device=dev) + 0.5,
             (0.5 * torch.randn(m, b, d, generator=g, device=dev)).to(dt),
             torch.randn(m, b, d, generator=g, device=dev))
    return pre.to(dt), r, state


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    log("device", name=name, count=torch.cuda.device_count(), nvidia_smi=repr(card),
        torch=torch.__version__, cuda=torch.version.cuda)
    return card


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build_all()
    secs = time.perf_counter() - t0
    for src, rep in reports.items():
        for fn, body in re.findall(r"Compiling entry function '(\w+)'.*?\n(.*?)(?=ptxas info    : Compiling|\Z)",
                                   rep, re.S):
            short = re.search(r"(matvec_partial_kernel|matvec_epilogue_kernel|ring_attn_kernel|"
                              r"ring_combine_kernel|logits_partial_kernel|logits_reduce_kernel|"
                              r"chunk_attn_kernel|slstm_kernel|decode_attn_kernel|"
                              r"decode_combine_kernel)(I.*?E)?", fn)
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
            smem = re.search(r"(\d+) bytes smem", body)
            log("build", source=f"{src}.cu",
                kernel=(short.group(0) if short else fn)[:60],
                registers=regs.group(1) if regs else "?",
                static_smem=smem.group(1) if smem else 0,
                spills=f"{spill.group(1)}/{spill.group(2)}" if spill else "?")
    log("build", sources=len(build.SOURCES), built=len(reports), seconds=round(secs, 2))


def phase_kernels(torch, dev):
    from repro_torch.kernels import chunk_prefill_attn as cpa
    from repro_torch.kernels import decode_layer as dl

    errs = {}
    # decode layer: pre-wrap, wrapped ring, sliding window over a wrapped ring
    g = torch.Generator(device=dev).manual_seed(7)
    cases = [("bfloat16", 0, 0, False), ("bfloat16", S, 0, True),
             ("bfloat16", 2 * S, 256, False), ("float32", S, 0, True)]
    for dtn, base, window, bias in cases:
        dt = getattr(torch, dtn)
        lp, x, ck, cv = layer_inputs(torch, dev, dt, 1, bias)
        pos = (base + torch.randint(0, S, (M, B), generator=g, device=dev)).to(torch.int32)
        kw = dict(num_heads=H, head_dim=HD, rope_theta=10000.0, window=window)
        want = dl.decode_layer_plain(lp, x, ck.clone(), cv.clone(), pos, **kw)
        got = dl.decode_layer_cuda(lp, x, ck.clone(), cv.clone(), pos, **kw)
        torch.cuda.synchronize()
        e = max(rel_err(a, b) for a, b in zip(got, want))
        assert e <= TOL[dtn], f"decode_layer {dtn} base={base} window={window}: {e}"
        errs[f"decode_layer/{dtn}/base{base}/w{window}"] = e
        del lp, x, ck, cv, got, want

    # greedy logits: duplicated winning column -> the first copy, exactly
    for xdt in ("bfloat16", "float32"):
        x, scale, head = logits_inputs(torch, dev, getattr(torch, xdt), 2)
        tok, val = dl.logits_argmax_cuda(x, scale, head)
        ptok, pval = dl.logits_argmax_plain(x, scale, head)
        torch.cuda.synchronize()
        assert (tok == 5).all(), f"logits {xdt}: first occurrence broken: {tok.tolist()}"
        e = rel_err(val, pval)
        assert e <= TOL["float32"], f"logits val {xdt}: {e}"
        errs[f"logits/{xdt}/dup"] = e
        x, scale, head = logits_inputs(torch, dev, getattr(torch, xdt), 3, dup=False)
        tok, val = dl.logits_argmax_cuda(x, scale, head)
        ptok, pval = dl.logits_argmax_plain(x, scale, head)
        torch.cuda.synchronize()
        assert torch.equal(tok, ptok), f"logits {xdt}: tokens differ"
        errs[f"logits/{xdt}/rand"] = rel_err(val, pval)
        del head
        # hymba-1.5b: d 1600, odd vocab 32001 (the kernel's scalar loads)
        x, scale, head = logits_inputs(torch, dev, getattr(torch, xdt), 12, d=YD, v=YV)
        tok, val = dl.logits_argmax_cuda(x, scale, head)
        ptok, pval = dl.logits_argmax_plain(x, scale, head)
        torch.cuda.synchronize()
        assert (tok == 5).all() and torch.equal(tok, ptok), f"logits V={YV} {xdt}: {tok.tolist()}"
        e = rel_err(val, pval)
        assert e <= TOL["float32"], f"logits V={YV} val {xdt}: {e}"
        errs[f"logits/{xdt}/V{YV}/dup"] = e
        del head

    # chunk attention: empty / mid / full / wrapped caches; pin, window, sink
    offs = [0, 1, 17, 200, 500, 992, 1000, 1023, 1024, 1100, 1500, 2047, 5, 64, 300, 3000]
    for dtn, pin, window, sink in (("bfloat16", 0, 0, 0), ("bfloat16", 0, 256, 0),
                                   ("bfloat16", 4, 256, 4), ("float32", 0, 0, 0)):
        dt = getattr(torch, dtn)
        q, k, v, off = chunk_inputs(torch, dev, dt, 4, M, B, offs)
        if pin:
            off = off.clamp(min=pin)
        kw = dict(s_cache=S, pin=pin, window=window, sink=sink)
        want = cpa.chunk_prefill_attention_plain(q, k, v, off, **kw)
        got = cpa.chunk_prefill_attention_cuda(q, k, v, off, **kw)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        assert e <= TOL[dtn], f"chunk {dtn} pin={pin} window={window} sink={sink}: {e}"
        errs[f"chunk/{dtn}/pin{pin}/w{window}/s{sink}"] = e
    # chunk attention at the hymba-1.5b width (G=5): the SWA group (128
    # pinned meta slots, window, meta sink) and the global group
    yoffs = [0, 96, 128, 150, 700, 1100, 1151, 1152, 1200, 1500, 2000, 2303, 2304, 3000, 40, 64]
    for dtn, s_c, pin, window in (("bfloat16", YSWA, 128, 1024), ("float32", YSWA, 128, 1024),
                                  ("bfloat16", YS, 0, 1 << 30), ("float32", YS, 0, 1 << 30)):
        dt = getattr(torch, dtn)
        q, k, v, off = chunk_inputs(torch, dev, dt, 13, M, B, yoffs, s=s_c, h=YH, kvh=YKVH)
        kw = dict(s_cache=s_c, pin=pin, window=window, sink=128)
        want = cpa.chunk_prefill_attention_plain(q, k, v, off, **kw)
        got = cpa.chunk_prefill_attention_cuda(q, k, v, off, **kw)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        assert e <= TOL[dtn], f"chunk hymba {dtn} S={s_c} pin={pin} window={window}: {e}"
        errs[f"chunk/hymba/{dtn}/S{s_c}/pin{pin}/w{window}/s128"] = e
        del q, k, v

    # decode attention at the hymba-1.5b width: G=5, S=1536, mixed kv_len
    from repro_torch.kernels import decode_attn as da
    for dtn in ("bfloat16", "float32"):
        q, k, v, kv_len = decode_attn_inputs(torch, dev, getattr(torch, dtn), 14)
        want = da.decode_attention_plain(q, k, v, kv_len)
        got = da.decode_attention_cuda(q, k, v, kv_len)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        assert e <= TOL[dtn], f"decode_attention {dtn}: {e}"
        errs[f"decode_attention/{dtn}/S{YS}/G5"] = e
        del q, k, v

    # sLSTM cell at the xlstm-1.3b width: decode (S=1, M=4 x B=4 slots) and
    # prefill (S=32, 4 lanes); r in param_dtype (f32) or bf16; a padded chunk
    from repro_torch.kernels import slstm_cell as sc
    f32, bf16 = torch.float32, torch.bfloat16
    for dt, rdt, m, b, s, junk in ((f32, f32, M, B, 1, False), (bf16, f32, M, B, 1, False),
                                   (f32, f32, 4, 1, C, False), (bf16, f32, 4, 1, C, False),
                                   (bf16, f32, M, B, C, True), (bf16, bf16, 4, 1, C, True)):
        pre, r, state = slstm_inputs(torch, dev, dt, rdt, m, b, s, 8, junk)
        want = tuple(t.clone() for t in state)
        want_hs, _ = sc.slstm_cell_plain(pre, r, want, num_heads=XH)
        got = tuple(t.clone() for t in state)
        got_hs, _ = sc.slstm_cell_cuda(pre, r, got, num_heads=XH)
        torch.cuda.synchronize()
        dtn = str(dt).removeprefix("torch.")
        e = max(rel_err(got_hs, want_hs), *(rel_err(a, w) for a, w in zip(got, want)))
        key = f"slstm_cell/{dtn}/r_{str(rdt).removeprefix('torch.')}/S{s}/B{b}" + (
            "/padded" if junk else "")
        assert e <= TOL[dtn], f"{key}: {e}"
        errs[key] = e
        del pre, r
    for key, e in errs.items():
        log("kernels", case=key, rel_err=f"{e:.3e}")
    log("kernels", cases=len(errs), tolerance_bf16=TOL["bfloat16"],
        tolerance_f32=TOL["float32"], status="ok")


def make_server(torch, dev, cfg, seed, **kw):
    from repro_torch import api
    from repro_torch.models.common import merge_instances
    from repro_torch.serving import MultiModelServer

    with torch.inference_mode():
        ones = [api.init(cfg.with_(num_instances=1),
                         torch.Generator(device=dev).manual_seed(seed * 1000 + i), dev)
                for i in range(cfg.num_instances)]
        merged = merge_instances(ones)
    del ones
    return MultiModelServer(cfg, merged, device=dev, **kw)


def requests(n, m, lo, hi, max_new, vocab, seed):
    import numpy as np
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    return [Request(i % m, rng.integers(1, vocab, int(rng.integers(lo, hi + 1))).tolist(),
                    max_new) for i in range(n)]


def serve_path(torch, dev, arch, kernels, max_context=S):
    """One main path: the full config of ``arch`` at M=4 instances, 16
    requests with prompts of 16-512 tokens and 32 new tokens each, greedy,
    K=8.  Every launch counter is set to 0 just before the run and read
    just after; each kernel in ``kernels`` must have launched."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops

    cfg = registry.get_config(arch).with_(num_instances=M)
    torch.cuda.reset_peak_memory_stats()
    srv = make_server(torch, dev, cfg, 0, slots_per_instance=B, max_context=max_context,
                      prefill_chunk=C, prefill_lanes=4, decode_steps=8)
    setup_peak = torch.cuda.max_memory_allocated()
    reqs = requests(16, M, 16, 512, 32, cfg.vocab_size, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    results = srv.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()
    snap = srv.metrics.snapshot()
    assert len(results) == 16 and all(r.status == "ok" for r in results)
    assert all(len(r.tokens) == 32 for r in results), [len(r.tokens) for r in results]
    assert all(0 <= t < cfg.vocab_size for r in results for t in r.tokens)
    for name in kernels:
        assert launches[name] > 0, f"{name} was never launched on the {arch} path"
    log("serve", arch=cfg.name, instances=M, slots=B, requests=len(results),
        tokens=snap["generated_tokens"], wall_s=round(wall, 3),
        tok_per_s=round(snap["generated_tokens"] / wall, 1),
        decode_steps=snap["decode_steps"], decode_blocks=snap["decode_device_calls"],
        ms_per_decode_step=round(snap["decode_ms_per_step"], 3),
        decode_tok_per_s=round(snap["decode_tok_per_s"], 1),
        prefill_ms=round(1e3 * snap["prefill_wall_s"], 1),
        prefill_chunk_calls=snap["prefill_batches"],
        prefill_tokens=snap["prefill_tokens"],
        launches=json.dumps(launches).replace(" ", ""),
        max_memory_allocated_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2),
        setup_peak_gib=round(setup_peak / 2 ** 30, 2))
    profile_serve(torch, srv, requests(16, M, 16, 512, 32, cfg.vocab_size, 5), arch)
    # the server holds a reference cycle (its step is a bound method): free
    # it now, or the next path's memory peak counts this path's weights
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return cfg, snap, launches


def phase_serve(torch, dev):
    from repro_torch.models import ssm

    cfg, snap, dense = serve_path(torch, dev, "tinyllama-1.1b",
                                  ("decode_layer", "chunk_prefill_attention", "logits_sample"))
    steps = snap["decode_steps"]
    log("serve", arch=cfg.name,
        decode_layer_launches_per_step=round(dense["decode_layer"] / steps, 2),
        logits_launches_per_step=round(dense["logits_sample"] / steps, 2),
        cuda_kernels_per_decode_step=10 * cfg.num_layers + 2)

    cfg, snap, xlstm = serve_path(torch, dev, "xlstm-1.3b", ("slstm_cell", "logits_sample"))
    n_slstm = len(ssm.mlstm_runs(cfg)) - 1
    calls = snap["prefill_batches"] + snap["decode_steps"]
    assert xlstm["slstm_cell"] == n_slstm * calls, (xlstm, n_slstm, calls)
    assert xlstm["decode_layer"] == xlstm["chunk_prefill_attention"] == 0, xlstm
    log("serve", arch=cfg.name, slstm_layers=n_slstm, chunk_calls_plus_decode_steps=calls,
        slstm_launches=xlstm["slstm_cell"],
        slstm_launches_check=f"{n_slstm}x{calls}=={xlstm['slstm_cell']}")

    from repro_torch.models import hybrid
    cfg, snap, hymba = serve_path(torch, dev, "hymba-1.5b",
                                  ("chunk_prefill_attention", "decode_attention",
                                   "logits_sample"), max_context=YS)
    steps, chunks = snap["decode_steps"], snap["prefill_batches"]
    n_global = len(hybrid.global_layers(cfg))
    assert hymba["decode_attention"] == n_global * steps, (hymba, n_global, steps)
    assert hymba["chunk_prefill_attention"] == cfg.num_layers * chunks, (hymba, chunks)
    assert hymba["logits_sample"] == steps, (hymba, steps)
    assert hymba["decode_layer"] == hymba["slstm_cell"] == 0, hymba
    log("serve", arch=cfg.name, global_layers=n_global, decode_steps=steps,
        decode_attention_launches=hymba["decode_attention"],
        decode_attention_check=f"{n_global}x{steps}=={hymba['decode_attention']}",
        chunk_launches_check=f"{cfg.num_layers}x{chunks}=={hymba['chunk_prefill_attention']}")
    return {"tinyllama-1.1b": dense, "xlstm-1.3b": xlstm, "hymba-1.5b": hymba}


def device_us(e):
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)


def profile_serve(torch, srv, reqs, arch):
    """Where the serve time goes: the same workload again under
    torch.profiler -- device busy share of the wall and the top kernels.
    The profiler's own overhead stretches this run's wall clock."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages() if device_us(e) > 0]
    busy = sum(device_us(e) for e in ev) / 1e6
    log("profile", run=f"serve/{arch}", wall_s=round(wall, 3), device_busy_s=round(busy, 3),
        device_idle_share=f"{1 - busy / wall:.1%}")
    for e in sorted(ev, key=device_us, reverse=True)[:8]:
        log("profile", run=f"serve/{arch}", kernel=e.key[:60], calls=e.count,
            device_ms=round(device_us(e) / 1e3, 2))


def phase_check(torch, dev):
    import numpy as np

    from repro_torch import api
    from repro_torch.configs import registry
    from repro_torch.models.common import _leaves, tree_map

    # greedy K=1 vs K=8 on the card at full widths, depth cut: tinyllama to
    # 4 layers, xlstm to 8 (7 mLSTM layers and the sLSTM layer at 3),
    # hymba to 4 (global layers 0, 2, 3 and the SWA layer 1)
    for arch, layers, ctx in (("tinyllama-1.1b", 4, S), ("xlstm-1.3b", 8, S),
                              ("hymba-1.5b", 4, YS)):
        cfg = registry.get_config(arch).with_(num_instances=M, num_layers=layers)
        streams = []
        for k in (1, 8):
            srv = make_server(torch, dev, cfg, 1, slots_per_instance=2, max_context=ctx,
                              prefill_chunk=C, decode_steps=k)
            for r in requests(12, M, 16, 200, 16, cfg.vocab_size, 1):
                srv.submit(r)
            streams.append({r.request_id: r.tokens for r in srv.run_until_drained()})
            del srv
            gc.collect()
        assert streams[0] == streams[1], f"{arch}: greedy streams differ between K=1 and K=8"
        log("check", arch=arch, streams="K1==K8", requests=len(streams[0]), layers=layers,
            tokens=sum(len(t) for t in streams[0].values()))

    # kernel path (card) against the plain path (CPU), small f32 configs:
    # prefill chunks (three of 8; hymba: eleven of 16 over the 128 meta
    # positions and 48 prompt tokens, wrapping its 32-slot SWA ring at
    # context 256), a decode step and a greedy decode step
    for arch, layers, n_pos, width, ctx in (("tinyllama-1.1b", None, 24, 8, 64),
                                            ("xlstm-1.3b", None, 24, 8, 64),
                                            ("hymba-1.5b", 4, 176, 16, 256)):
        small = registry.get_smoke_config(arch).with_(num_instances=2)
        if layers:
            small = small.with_(num_layers=layers)
        params = api.init(small, torch.Generator().manual_seed(0), "cpu")
        rng = np.random.default_rng(2)
        tok = torch.from_numpy(rng.integers(1, small.vocab_size, (2, 2, n_pos)).astype(np.int32))
        outs = {}
        for d in ("cpu", dev):
            p = params.to(d) if d != "cpu" else params
            carry = api.init_chunk_carry(small, 2, 2, ctx, device=d)
            for start in range(0, n_pos, width):
                off = torch.full((2, 2), start, dtype=torch.int32, device=d)
                api.prefill_chunk(small, p, {"tokens": tok[:, :, start:start + width].to(d)},
                                  carry, off)
            cache = carry["cache"]
            pos = torch.full((2, 2), n_pos, dtype=torch.int32, device=d)
            nxt, _ = api.decode_step_sample(small, p, tree_map(lambda t: t.clone(), cache),
                                            tok[:, :, -1:].to(d), pos)
            logits, _ = api.decode_step(small, p, cache, tok[:, :, -1:].to(d), pos)
            outs[str(d)] = ([t.cpu() for t in _leaves(cache)], logits.cpu(), nxt.cpu())
        (c0, lg0, n0), (c1, lg1, n1) = outs["cpu"], outs[str(dev)]
        e_cache = max(rel_err(a, b) for a, b in zip(c1, c0))
        e_logits = rel_err(lg1, lg0)
        assert torch.isfinite(lg1).all() and lg1.shape == (2, 2, small.vocab_size)
        assert e_cache <= TOL["float32"] and e_logits <= TOL["float32"], (arch, e_cache,
                                                                          e_logits)
        assert torch.equal(n1, n0) and torch.equal(n1, lg0.argmax(-1).to(torch.int32)), (
            f"{arch}: greedy tokens differ")
        log("check", reference="cpu-plain", config=small.name, layers=small.num_layers,
            prefilled_positions=n_pos, state_leaves=len(c0),
            cache_rel_err=f"{e_cache:.2e}", logits_rel_err=f"{e_logits:.2e}", tokens="equal")


def time_ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_queued_ms(torch, fn, reps=20):
    """Device time per call of a kernel too short to outrun its host-side
    launch: the calls are queued behind a spin kernel (~10 ms), so the
    device runs them back to back however slowly the host enqueues them."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_times(torch, dev, by_path):
    import torch.nn.functional as Fn

    from repro_torch.kernels import chunk_prefill_attn as cpa
    from repro_torch.kernels import decode_layer as dl

    rows = []
    g = torch.Generator(device=dev).manual_seed(11)
    # launches on the main paths: each kernel's count summed over the paths
    # (set to 0 before each path and read after it), and split per path
    launches = {k: sum(p[k] for p in by_path.values()) for k in by_path["xlstm-1.3b"]}
    per_path = lambda k: {a: p[k] for a, p in by_path.items() if p[k]}

    # decode layer at the serve shapes: bf16, positions inside the prompts' range
    lp, x, ck, cv = layer_inputs(torch, dev, torch.bfloat16, 5)
    pos = torch.randint(16, 545, (M, B), generator=g, device=dev).to(torch.int32)
    kw = dict(num_heads=H, head_dim=HD, rope_theta=10000.0)
    got = dl.decode_layer_cuda(lp, x, ck.clone(), cv.clone(), pos, **kw)
    want = dl.decode_layer_plain(lp, x, ck.clone(), cv.clone(), pos, **kw)
    err = abs_err(got[0], want[0])
    ms = time_ms(torch, lambda: dl.decode_layer_cuda(lp, x, ck, cv, pos, **kw))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            dl.decode_layer_cuda(lp, x, ck, cv, pos, **kw)
        torch.cuda.synchronize()
    for e in sorted(prof.key_averages(), key=device_us, reverse=True)[:6]:
        if device_us(e) > 0:
            log("profile", run="decode_layer", kernel=e.key[:60], calls=e.count,
                device_us_per_call=round(device_us(e) / e.count, 1))
    plain = time_ms(torch, lambda: dl.decode_layer_plain(lp, x, ck, cv, pos, **kw))
    n_w = D * (H + 2 * KVH) * HD + H * HD * D + 3 * D * F
    valid = (pos + 1).clamp(max=S).sum().item()
    nbytes = (M * n_w * 2 + 2 * M * D * 4 + 2 * M * B * D * 2
              + valid * KVH * HD * 2 * 2 + M * B * KVH * HD * 2 * 2 + M * B * 4)
    flops = 2 * M * B * n_w + 4 * H * HD * valid
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    rows.append(dict(name="decode_layer", route="cuda",
                     source="src/repro_torch/csrc/decode_layer.cu",
                     replaces="src/repro/kernels/decode_layer.py:144",
                     launches=launches["decode_layer"],
                     launches_by_path=per_path("decode_layer"), max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None))
    del lp, x, ck, cv

    # greedy logits at the serve shapes: bf16 residual, f32 head (param_dtype)
    x, scale, head = logits_inputs(torch, dev, torch.bfloat16, 6, dup=False)
    tok, val = dl.logits_argmax_cuda(x, scale, head)
    ptok, pval = dl.logits_argmax_plain(x, scale, head)
    assert torch.equal(tok, ptok)
    err = abs_err(val, pval)
    ms = time_ms(torch, lambda: dl.logits_argmax_cuda(x, scale, head))
    plain = time_ms(torch, lambda: dl.logits_argmax_plain(x, scale, head))
    nbytes = M * D * V * 4 + M * B * D * 2 + M * D * 4 + M * B * 8
    bms, by = bound_ms(nbytes, 2 * M * B * D * V, "float32")
    rows.append(dict(name="logits_sample", route="cuda",
                     source="src/repro_torch/csrc/decode_layer.cu",
                     replaces="src/repro/kernels/decode_layer.py:414",
                     launches=launches["logits_sample"],
                     launches_by_path=per_path("logits_sample"), max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None))
    del head

    # chunk attention at the serve shapes: 4 prefill lanes (M=4, B=1), bf16;
    # 16 input copies rotate so K/V come from HBM, not L2, as in prefill
    offs = [0, 96, 256, 480]
    sets = [chunk_inputs(torch, dev, torch.bfloat16, 20 + i, 4, 1, offs) for i in range(16)]
    q, k, v, off = sets[0]
    got = cpa.chunk_prefill_attention_cuda(q, k, v, off, s_cache=S)
    want = cpa.chunk_prefill_attention_plain(q, k, v, off, s_cache=S)
    err = abs_err(got, want)
    it = iter(range(10 ** 9))
    ms = time_ms(torch, lambda: cpa.chunk_prefill_attention_cuda(
        *sets[next(it) % 16], s_cache=S))
    plain = time_ms(torch, lambda: cpa.chunk_prefill_attention_plain(
        *sets[next(it) % 16], s_cache=S), reps=5)
    # the same function as one library call: SDPA with the boolean mask
    from repro_torch.models.layers import cache_positions_after
    positions = off[..., None] + torch.arange(C, device=dev, dtype=torch.int32)
    kv_pos = torch.cat([cache_positions_after(off - 1, S), positions], -1)  # (4,1,T)
    mask = (kv_pos[:, :, None, :] >= 0) & (kv_pos[:, :, None, :] <= positions[..., None])
    lib_in = [(s_[0][:, 0].transpose(1, 2), s_[1][:, 0].transpose(1, 2),
               s_[2][:, 0].transpose(1, 2)) for s_ in sets]
    lib = lambda i: Fn.scaled_dot_product_attention(
        *lib_in[i % 16], attn_mask=mask, enable_gqa=True)
    lib_out = lib(0).transpose(1, 2)[:, None]
    assert abs_err(lib_out, want) < 0.05
    library = time_ms(torch, lambda: lib(next(it)))
    vis_keys = mask.any(dim=2).sum().item()              # keys any query sees
    pairs = mask.sum().item()                            # visible (query, key) pairs
    nbytes = 2 * 4 * C * H * HD * 2 + vis_keys * KVH * HD * 2 * 2 + 4 * 4
    bms, by = bound_ms(nbytes, 4 * H * HD * pairs, "bfloat16")
    rows.append(dict(name="chunk_prefill_attention", route="cuda",
                     source="src/repro_torch/csrc/chunk_prefill_attn.cu",
                     replaces="src/repro/kernels/chunk_prefill_attn.py:35",
                     launches=launches["chunk_prefill_attention"],
                     launches_by_path=per_path("chunk_prefill_attention"), max_abs_err=err,
                     ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=library))

    # sLSTM cell: prefill (S=32 over 4 lanes) in the row; decode (S=1 over
    # M=4 x B=4 slots) beside it.  bf16 activations, r in param_dtype (f32).
    from repro_torch.kernels import slstm_cell as sc

    def slstm_time(m, b, s):
        pre, r, state = slstm_inputs(torch, dev, torch.bfloat16, torch.float32, m, b, s, 12)
        got = tuple(t.clone() for t in state)
        want = tuple(t.clone() for t in state)
        ghs, _ = sc.slstm_cell_cuda(pre, r, got, num_heads=XH)
        whs, _ = sc.slstm_cell_plain(pre, r, want, num_heads=XH)
        err = max(abs_err(a, w) for a, w in zip((ghs,) + got, (whs,) + want))
        ms = time_ms(torch, lambda: sc.slstm_cell_cuda(pre, r, got, num_heads=XH))
        plain = time_ms(torch, lambda: sc.slstm_cell_plain(pre, r, want, num_heads=XH), reps=5)
        d = XH * XHD
        # each input read once, each output written once: pre, r, the state
        # (c, n, m f32 and h bf16) in and out, hs; the recurrent matvec in f32
        nbytes = (pre.numel() * 2 + r.numel() * 4 + 2 * m * b * d * (3 * 4 + 2)
                  + m * b * s * d * 2)
        flops = 2 * m * b * s * 4 * d * XHD
        return err, ms, plain, bound_ms(nbytes, flops, "float32")

    err, ms, plain, (bms, by) = slstm_time(4, 1, C)
    d_err, d_ms, d_plain, (d_bms, d_by) = slstm_time(M, B, 1)
    rows.append(dict(name="slstm_cell", route="cuda",
                     source="src/repro_torch/csrc/slstm_cell.cu",
                     replaces="src/repro/kernels/slstm_cell.py:37",
                     launches=launches["slstm_cell"],
                     launches_by_path=per_path("slstm_cell"), max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                     shape="prefill S=32, 4 lanes", decode_ms=d_ms, decode_plain_ms=d_plain,
                     decode_bound_ms=d_bms, decode_bound_by=d_by, decode_max_abs_err=d_err))
    log("times", name="slstm_cell", shape="decode S=1, M=4 x B=4", ms=f"{d_ms:.4f}",
        plain_ms=f"{d_plain:.4f}", bound_ms=f"{d_bms:.4f}", bound_by=d_by,
        of_bound=f"{d_bms / d_ms:.1%}")
    # decode attention at the hymba serve shapes: M=4 x B=4 slots, bf16,
    # kv_len inside the served positions (128 meta + 16..512 prompt + 32
    # new); 8 input copies rotate so K/V come from HBM, as in a decode step
    # where 32 layers of weights stream through L2 between two global layers
    from repro_torch.kernels import decode_attn as da
    sets = [decode_attn_inputs(torch, dev, torch.bfloat16, 30 + i, lens=(144, 673))
            for i in range(8)]
    q, k, v, kv_len = sets[0]
    got = da.decode_attention_cuda(q, k, v, kv_len)
    want = da.decode_attention_plain(q, k, v, kv_len)
    err = abs_err(got, want)
    it = iter(range(10 ** 9))
    ms = time_ms(torch, lambda: da.decode_attention_cuda(*sets[next(it) % 8]))
    plain = time_ms(torch, lambda: da.decode_attention_plain(*sets[next(it) % 8]), reps=5)
    device_ms = time_queued_ms(torch, lambda: da.decode_attention_cuda(*sets[next(it) % 8]))
    # the same function as one library call: SDPA, the prefix mask, GQA
    lib_in = []
    for q_, k_, v_, l_ in sets:
        mask = (torch.arange(YS, device=dev) < l_[..., None]).reshape(M * B, 1, 1, YS)
        lib_in.append((q_.reshape(M * B, YH, 1, HD), k_.reshape(M * B, YS, YKVH, HD).transpose(1, 2),
                       v_.reshape(M * B, YS, YKVH, HD).transpose(1, 2), mask))
    lib = lambda i: Fn.scaled_dot_product_attention(
        *lib_in[i % 8][:3], attn_mask=lib_in[i % 8][3], enable_gqa=True)
    assert abs_err(lib(0).reshape(M, B, YH, HD), want) < 0.05
    library = time_ms(torch, lambda: lib(next(it)))
    valid = kv_len.sum().item()
    nbytes = 2 * M * B * YH * HD * 2 + valid * YKVH * HD * 2 * 2 + M * B * 4
    bms, by = bound_ms(nbytes, 4 * YH * HD * valid, "bfloat16")
    rows.append(dict(name="decode_attention", route="cuda",
                     source="src/repro_torch/csrc/decode_attn.cu",
                     replaces="src/repro/kernels/decode_attn.py:25",
                     launches=launches["decode_attention"],
                     launches_by_path=per_path("decode_attention"), max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=library,
                     device_ms=device_ms))
    del sets, lib_in

    for r in rows:
        log("times", name=r["name"], ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            bound_ms=f"{r['bound_ms']:.4f}", bound_by=r["bound_by"],
            library_ms=r["library_ms"], of_bound=f"{r['bound_ms'] / r['ms']:.1%}",
            **({"device_ms": f"{r['device_ms']:.4f}"} if "device_ms" in r else {}))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    phase_device(torch)
    phase_build()
    phase_kernels(torch, dev)
    torch.cuda.empty_cache()
    launches = phase_serve(torch, dev)
    phase_check(torch, dev)
    torch.cuda.empty_cache()
    rows = phase_times(torch, dev, launches)
    log("done", seconds=round(time.perf_counter() - t0, 1))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
