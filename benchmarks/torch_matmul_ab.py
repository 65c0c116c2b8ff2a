#!/usr/bin/env python3
"""Time the merged-matmul kernel (``csrc/fused_matmul.cu``) of a checkout
on the card, to compare two versions of it within one machine session.

  python3 benchmarks/torch_matmul_ab.py [ROOT] [--tag NAME]

ROOT is the root of the checkout whose ``src/repro_torch`` is imported
(default: this one); its kernels build into ROOT/build/kernels.  Run it
once per version, alternating (parent, change, change, parent).  Each
shape and dtype: 10 warm-up calls, then 200 back to back timed with CUDA
events, 8 weight sets rotating so that w comes from HBM, with bias.
Prints one line ``AB {"tag": ..., "ms": {"MxTxDxF/dtype": ms, ...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

SHAPES = ((4, 4, 2048, 5632), (32, 128, 768, 3072), (2, 4, 2048, 2816), (16, 128, 768, 1536))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=os.path.join(os.path.dirname(__file__), ".."))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import torch

    if not torch.cuda.is_available():
        print("torch_matmul_ab: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import fused_matmul as fm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for m, t, d, f in SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            sets = [(torch.randn(m, t, d, generator=g, device=dev).to(dt),
                     (torch.randn(m, d, f, generator=g, device=dev) * d ** -0.5).to(dt),
                     torch.randn(m, f, generator=g, device=dev)) for _ in range(8)]
            for i in range(10):
                fm.fused_matmul_cuda(*sets[i % 8])
            torch.cuda.synchronize()
            reps = 200
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for i in range(reps):
                fm.fused_matmul_cuda(*sets[i % 8])
            b.record()
            torch.cuda.synchronize()
            out[f"{m}x{t}x{d}x{f}/{str(dt).removeprefix('torch.')}"] = a.elapsed_time(b) / reps
    print("AB " + json.dumps({"tag": args.tag, "source": fm.__file__, "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
