#!/usr/bin/env python3
"""Time the merged-matmul (``csrc/fused_matmul.cu``) and chunk-attention
(``csrc/chunk_prefill_attn.cu``) kernels of a checkout on the card, to
compare two versions of them within one machine session.

  python3 benchmarks/torch_matmul_ab.py [ROOT] [--tag NAME]

ROOT is the root of the checkout whose ``src/repro_torch`` is imported
(default: this one); its kernels build into ROOT/build/kernels.  Run it
once per version, alternating (parent, change, change, parent).

- The merged matmul at four shapes, bf16 and f32, with bias: 10 warm-up
  calls, then 200 back to back timed with CUDA events, 8 weight sets
  rotating so that w comes from HBM.
- The chunk attention at tinyllama-1.1b's serve shape (4 lanes, C=32,
  S=1024, 32/4 heads, hd 64, offsets 0/96/256/480) and at hymba-1.5b's
  SWA geometry (25/5 heads, S=1152, pin 128, window 1024, sink 128),
  bf16 and f32: 16 input sets rotating, 200 calls.
- Each also as device time: the same calls queued behind a ~10 ms spin
  kernel, so the device runs them back to back however slowly the host
  enqueues them.
- Beside them, in every run, the one PyTorch call that computes the same
  function (``torch.bmm``; SDPA with the boolean mask at the tinyllama
  shape), timed the same two ways.

Prints one line ``AB {"tag": ..., "ms": {...}, "device_ms": {...},
"library_ms": {...}, "library_device_ms": {...}}``, keys
``matmul/MxTxDxF/dtype`` and ``chunk/NAME/dtype``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

SHAPES = ((4, 4, 2048, 5632), (32, 128, 768, 3072), (2, 4, 2048, 2816), (16, 128, 768, 1536))
# name: (lanes, C, H, KVH, hd, s_cache, pin, window, sink, offsets)
CHUNKS = {"tinyllama": (4, 32, 32, 4, 64, 1024, 0, 0, 0, (0, 96, 256, 480)),
          "hymba_swa": (4, 32, 25, 5, 64, 1152, 128, 1024, 128, (128, 400, 900, 1500))}


def timed(torch, fn, reps=200, warmup=10):
    """(event ms per call, device ms per call queued behind a spin)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / reps
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(reps // 4):
        fn()
    b.record()
    torch.cuda.synchronize()
    return ms, a.elapsed_time(b) / (reps // 4)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=os.path.join(os.path.dirname(__file__), ".."))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import torch
    import torch.nn.functional as Fn

    if not torch.cuda.is_available():
        print("torch_matmul_ab: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import chunk_prefill_attn as cpa
    from repro_torch.kernels import fused_matmul as fm
    from repro_torch.models.layers import cache_positions_after

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    res = {"ms": {}, "device_ms": {}, "library_ms": {}, "library_device_ms": {}}

    def record(key, kern, lib=None):
        res["ms"][key], res["device_ms"][key] = timed(torch, kern)
        if lib is not None:
            res["library_ms"][key], res["library_device_ms"][key] = timed(torch, lib)

    for m, t, d, f in SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            sets = [(torch.randn(m, t, d, generator=g, device=dev).to(dt),
                     (torch.randn(m, d, f, generator=g, device=dev) * d ** -0.5).to(dt),
                     torch.randn(m, f, generator=g, device=dev)) for _ in range(8)]
            it = iter(range(10 ** 9))
            lib = (lambda: torch.bmm(*sets[next(it) % 8][:2])) if dt == torch.bfloat16 else None
            record(f"matmul/{m}x{t}x{d}x{f}/{str(dt).removeprefix('torch.')}",
                   lambda: fm.fused_matmul_cuda(*sets[next(it) % 8]), lib)
            del sets

    for name, (lanes, c, h, kvh, hd, s, pin, win, sink, offs) in CHUNKS.items():
        for dt in (torch.bfloat16, torch.float32):
            off = torch.tensor(offs, dtype=torch.int32, device=dev)[:, None]
            sets = [tuple(torch.randn(lanes, 1, n, hh, hd, generator=g, device=dev).to(dt)
                          for n, hh in ((c, h), (s + c, kvh), (s + c, kvh)))
                    for _ in range(16)]
            kw = dict(s_cache=s, pin=pin, window=win, sink=sink)
            it = iter(range(10 ** 9))
            lib = None
            if name == "tinyllama" and dt == torch.bfloat16:
                pos = off[..., None] + torch.arange(c, device=dev, dtype=torch.int32)
                kv_pos = torch.cat([cache_positions_after(off - 1, s), pos], -1)
                mask = (kv_pos[:, :, None, :] >= 0) & (kv_pos[:, :, None, :] <= pos[..., None])
                lib_in = [tuple(a[:, 0].transpose(1, 2) for a in st) for st in sets]
                lib = lambda: Fn.scaled_dot_product_attention(
                    *lib_in[next(it) % 16], attn_mask=mask, enable_gqa=True)
            record(f"chunk/{name}/{str(dt).removeprefix('torch.')}",
                   lambda: cpa.chunk_prefill_attention_cuda(*sets[next(it) % 16], off, **kw),
                   lib)
            del sets
    assert all(math.isfinite(v) for r in res.values() for v in r.values())
    print("AB " + json.dumps({"tag": args.tag, "source": fm.__file__,
                              "card": torch.cuda.get_device_name(0), **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
