#!/usr/bin/env python3
"""Time the Hopper kernels of a checkout on the card, to compare two
versions of them on one card in one run: the merged matmul
(``csrc/fused_matmul.cu``), the chunk attention
(``csrc/chunk_prefill_attn.cu``), the sLSTM cell (``csrc/slstm_cell.cu``),
the dense decode layer (``csrc/decode_layer.cu``), the decode attention
(``csrc/decode_attn.cu``) and the chunkwise mLSTM
(``csrc/mlstm_chunk.cu``).

  python3 benchmarks/torch_kernel_ab.py [ROOT] [--tag NAME] [--only PREFIX,...]

ROOT is the root of the checkout whose ``src/repro_torch`` is imported
(default: this one); its kernels build into ROOT/build/kernels.  Run it
once per version, alternating (parent, change, change, parent).  Every
wrapper timed here has the same Python contract in both versions.

- The merged matmul at six shapes (two of them olmoe-1b-7b's expert
  products and one instance of a skinny shape), bf16 and f32, with bias: 10 warm-up
  calls, then 200 back to back timed with CUDA events, 8 weight sets
  rotating so that w comes from HBM.
- The chunk attention at tinyllama-1.1b's serve shape (4 lanes, C=32,
  S=1024, 32/4 heads, hd 64, offsets 0/96/256/480; and one lane alone)
  and at hymba-1.5b's SWA geometry (25/5 heads, S=1152, pin 128, window
  1024, sink 128),
  bf16 and f32: 16 input sets rotating, 200 calls.
- The sLSTM cell at xlstm-1.3b's width (4 heads of 512, r in f32): a
  prefill chunk (4 lanes, S=32) and a decode step (M=4 x B=4, S=1), pre
  and h in bf16 and in f32; 2 input sets rotating, so r comes from HBM
  at every call as in a serve.
- The dense decode layer at tinyllama-1.1b's width (B=4, ring of 1024,
  positions inside the prompts' range): the whole layer at M=4, at a 2x1
  data rank's M=2 and at M=1, bf16 and f32, and a TP=2 rank's attention
  and FFN phases at M=4 (16/2 heads, F 2816),
  bf16 and f32; 4 weight sets rotating.
- The decode attention at hymba-1.5b's serve shape (M=4 x B=4 lanes, S
  1536, 25 / 5 heads of 64, kv_len in [144, 673), the TP=2 rank's shape
  too) and at the per-rank shapes of the other two TP plans ("kv" at
  TP=5: 5 / 1 heads; "expand" at TP=25: 1 / 1), bf16 and f32; 8 input
  sets rotating, so K and V come from HBM.  Beside it SDPA with the
  prefix mask (GQA), and the latency floor: an empty kernel launched on
  the decode attention's grid and cluster shape (where the checkout has
  one).
- The chunkwise mLSTM at xlstm-1.3b's profiler shape (q, k, v (4, 4, 4,
  32, 1024), chunk 32) and over four chunks (4, 1, 4, 256, 1024, chunk 64),
  bf16 and f32; 2 input sets rotating.
- Each also as device time: the same calls queued behind a ~10 ms spin
  kernel, so the device runs them back to back however slowly the host
  enqueues them.
- Beside them, in every run, the one PyTorch call that computes the same
  function where there is one (``torch.bmm``; SDPA with the boolean mask
  at the tinyllama shape), timed the same two ways.
- The L2 probe: the device time of ``torch.sum`` reading a 24 MiB f32
  buffer 32 times over (a stride-0 view, so the lines come from the 50
  MB L2), against one read of 1 GiB (HBM): the read rates the sLSTM
  cell's design floor is computed from.

Prints one line ``AB {"tag": ..., "ms": {...}, "device_ms": {...},
"library_ms": {...}, "library_device_ms": {...}, "rate_tb_s": {...}}``,
keys ``matmul/MxTxDxF/dtype``, ``chunk/NAME/dtype``,
``slstm/prefill|decode/dtype``, ``decode_layer/layer|layer_m2|layer_m1|attn_tp2|ffn_tp2/dtype``,
``decode_attn/hymba|kv_tp5|expand_tp25/dtype``, ``floor/decode_attn``,
``mlstm/profiler|multichunk/dtype`` and ``l2``/``hbm``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

# (1, 4, 2048, 1024): one instance of a skinny shape; (256, 4, 2048, 1024):
# olmoe-1b-7b's expert products at a decode step (M=4 x 64 experts)
SHAPES = ((4, 4, 2048, 5632), (32, 128, 768, 3072), (2, 4, 2048, 2816), (16, 128, 768, 1536),
          (1, 4, 2048, 1024), (256, 4, 2048, 1024))
# name: (lanes, C, H, KVH, hd, s_cache, pin, window, sink, offsets)
# the sLSTM cell: name: (rows, lanes, steps)
SLSTM = {"prefill": (4, 1, 32), "decode": (4, 4, 1)}
# the decode layer: name: (instances, q heads, kv heads, d_ff) of the whole
# layer (at M=4, a 2x1 data rank's M=2 and one instance) and of a TP=2
# rank's phases
LAYERS = {"layer": (4, 32, 4, 5632), "layer_m2": (2, 32, 4, 5632), "layer_m1": (1, 32, 4, 5632),
          "attn_tp2": (4, 16, 2, 2816), "ffn_tp2": (4, 16, 2, 2816)}
CHUNKS = {"tinyllama": (4, 32, 32, 4, 64, 1024, 0, 0, 0, (0, 96, 256, 480)),
          "hymba_swa": (4, 32, 25, 5, 64, 1152, 128, 1024, 128, (128, 400, 900, 1500)),
          "tinyllama_lanes1": (1, 32, 32, 4, 64, 1024, 0, 0, 0, (480,))}
# the decode attention: name: (q heads, kv heads) of a call at M=4 x B=4,
# S 1536, hd 64 (hymba-1.5b whole, as one device and a TP=2 rank run it;
# a TP=5 rank's "kv" block; a TP=25 rank's "expand" block)
DECODE = {"hymba": (25, 5), "kv_tp5": (5, 1), "expand_tp25": (1, 1)}
# the chunkwise mLSTM: name: (M, B, H, S, hd, chunk)
MLSTM = {"profiler": (4, 4, 4, 32, 1024, 32), "multichunk": (4, 1, 4, 256, 1024, 64)}


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
    ap.add_argument("--only", default="", help="comma-separated key prefixes to time")
    args = ap.parse_args()
    only = [p for p in args.only.split(",") if p]
    want = lambda key: not only or any(key.startswith(p) for p in only)
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import torch
    import torch.nn.functional as Fn

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import chunk_prefill_attn as cpa
    from repro_torch.kernels import decode_layer as dl
    from repro_torch.kernels import fused_matmul as fm
    from repro_torch.kernels import slstm_cell as sc
    from repro_torch.models.layers import cache_positions_after

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    res = {"ms": {}, "device_ms": {}, "library_ms": {}, "library_device_ms": {},
           "rate_tb_s": {}}

    def record(key, kern, lib=None):
        res["ms"][key], res["device_ms"][key] = timed(torch, kern)
        if lib is not None:
            res["library_ms"][key], res["library_device_ms"][key] = timed(torch, lib)

    for m, t, d, f in SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            if not want(f"matmul/{m}x{t}x{d}x{f}"):
                continue
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
            if not want(f"chunk/{name}"):
                continue
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
    # the sLSTM cell: xlstm-1.3b's 4 heads of 512, r in f32
    for name, (m, b, s) in SLSTM.items():
        for dt in (torch.bfloat16, torch.float32):
            key = f"slstm/{name}/{str(dt).removeprefix('torch.')}"
            if not want(key):
                continue
            d = 4 * 512
            sets = []
            for _ in range(2):
                state = (torch.randn(m, b, d, generator=g, device=dev),
                         torch.rand(m, b, d, generator=g, device=dev) + 0.5,
                         (0.5 * torch.randn(m, b, d, generator=g, device=dev)).to(dt),
                         torch.randn(m, b, d, generator=g, device=dev))
                sets.append((torch.randn(m, b, s, 4, d, generator=g, device=dev).to(dt),
                             torch.randn(m, 4, 4, 512, 512, generator=g, device=dev) / 512 ** 0.5,
                             state))
            it = iter(range(10 ** 9))
            record(key, lambda: (lambda st: sc.slstm_cell_cuda(st[0], st[1], st[2],
                                                               num_heads=4))(sets[next(it) % 2]))
            del sets

    # the dense decode layer: tinyllama-1.1b's width, M = 4 x B = 4
    for name, (m, h, kvh, ff) in LAYERS.items():
        for dt in (torch.bfloat16, torch.float32):
            key = f"decode_layer/{name}/{str(dt).removeprefix('torch.')}"
            if not want(key):
                continue
            b, d, hd, s = 4, 2048, 64, 1024
            sets = []
            for _ in range(4):
                r = lambda *shp, sc_=1.0: torch.randn(shp, generator=g, device=dev) * sc_
                lp = {"attn_norm": 1 + 0.1 * r(m, d), "mlp_norm": 1 + 0.1 * r(m, d),
                      "wq": r(m, d, h * hd, sc_=d ** -0.5).to(dt),
                      "wk": r(m, d, kvh * hd, sc_=d ** -0.5).to(dt),
                      "wv": r(m, d, kvh * hd, sc_=d ** -0.5).to(dt),
                      "wo": r(m, h * hd, d, sc_=(h * hd) ** -0.5).to(dt),
                      "w_gate": r(m, d, ff, sc_=d ** -0.5).to(dt),
                      "w_up": r(m, d, ff, sc_=d ** -0.5).to(dt),
                      "w_down": r(m, ff, d, sc_=ff ** -0.5).to(dt)}
                sets.append((lp, r(m, b, d).to(dt), r(m, b, s, kvh, hd).to(dt),
                             r(m, b, s, kvh, hd).to(dt)))
            pos = torch.randint(16, 545, (m, b), generator=g, device=dev).to(torch.int32)
            kw = dict(num_heads=h, head_dim=hd, rope_theta=10000.0)
            it = iter(range(10 ** 9))
            if name.startswith("layer"):
                fn = lambda st: dl.decode_layer_cuda(st[0], st[1], st[2], st[3], pos, **kw)
            elif name == "attn_tp2":
                fn = lambda st: dl.decode_layer_attn_cuda(st[0], st[1], st[2], st[3], pos, **kw)
            else:
                fn = lambda st: dl.ffn_cuda(st[1], *(st[0][k] for k in ("mlp_norm", "w_gate",
                                                                        "w_up", "w_down")))
            record(key, lambda: fn(sets[next(it) % 4]))
            del sets

    # the decode attention: hymba-1.5b's serve shape and the TP plans' rank
    # blocks, kv_len inside the served positions (128 meta + 16..512 prompt
    # + 32 new)
    from repro_torch.kernels import decode_attn as da
    for name, (h, kvh) in DECODE.items():
        for dt in (torch.bfloat16, torch.float32):
            key = f"decode_attn/{name}/{str(dt).removeprefix('torch.')}"
            if not want(key):
                continue
            m, b, s, hd = 4, 4, 1536, 64
            sets = []
            for _ in range(8):
                q = torch.randn(m, b, h, hd, generator=g, device=dev).to(dt)
                k, v = (torch.randn(m, b, s, kvh, hd, generator=g, device=dev).to(dt)
                        for _ in range(2))
                lens = torch.randint(144, 673, (m, b), generator=g, device=dev,
                                     dtype=torch.int32)
                mask = (torch.arange(s, device=dev) < lens[..., None]).reshape(m * b, 1, 1, s)
                lib = (q.reshape(m * b, h, 1, hd), k.reshape(m * b, s, kvh, hd).transpose(1, 2),
                       v.reshape(m * b, s, kvh, hd).transpose(1, 2), mask)
                sets.append(((q, k, v, lens), lib))
            it = iter(range(10 ** 9))
            sdpa = lambda st: Fn.scaled_dot_product_attention(*st[:3], attn_mask=st[3],
                                                               enable_gqa=True)
            record(key, lambda: da.decode_attention_cuda(*sets[next(it) % 8][0]),
                   lambda: sdpa(sets[next(it) % 8][1]))
            if hasattr(da, "launch_floor") and name == "hymba" and dt == torch.bfloat16:
                plan = da.launch_plan(m * b, s, h, kvh, hd)
                res["ms"]["floor/decode_attn"], res["device_ms"]["floor/decode_attn"] = timed(
                    torch, lambda: da.launch_floor(plan, dev))
            del sets

    # the chunkwise mLSTM
    from repro_torch.kernels import mlstm_chunk as ml
    for name, (m, b, h, s, hd, chunk) in MLSTM.items():
        for dt in (torch.bfloat16, torch.float32):
            key = f"mlstm/{name}/{str(dt).removeprefix('torch.')}"
            if not want(key):
                continue
            sets = []
            for _ in range(2):
                q, k, v = (torch.randn(m, b, h, s, hd, generator=g, device=dev).to(dt)
                           for _ in range(3))
                lf = Fn.logsigmoid(2 + torch.randn(m, b, h, s, generator=g, device=dev))
                li = torch.randn(m, b, h, s, generator=g, device=dev)
                sets.append((q, k, v, lf, li))
            it = iter(range(10 ** 9))
            record(key, lambda: ml.mlstm_chunkwise_cuda(*sets[next(it) % 2], chunk=chunk))
            del sets

    # the L2 probe: one streaming read of 1 GiB, 32 times over a 24 MiB
    # buffer that stays in L2 (a stride-0 view: the same lines re-read)
    if want("l2"):
        for name, mib, reps in (("l2", 24, 32), ("hbm", 1024, 1)):
            buf = torch.randn(mib * 2 ** 18, generator=g, device=dev)
            view = buf.view(1, -1).expand(reps, -1)
            view.sum()
            _, dms = timed(torch, lambda: view.sum(), reps=40)
            res["device_ms"][name] = dms
            res["rate_tb_s"][name] = reps * mib * 2 ** 20 / (dms * 1e-3) / 1e12
            del buf, view
    assert all(math.isfinite(v) for r in res.values() for v in r.values())
    print("AB " + json.dumps({"tag": args.tag, "source": fm.__file__,
                              "card": torch.cuda.get_device_name(0), **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
