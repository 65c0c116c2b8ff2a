"""Serving launcher (port of ``repro.launch.serve``, dense, ssm and hybrid
families).

Initialises M "fine-tuned" instances as M random initialisations from a
seed, merges them (the paper's offline merge step, timed), and serves a
synthetic request mix from per-instance queues through the merged
program.  Runs on the CUDA device unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \\
      --smoke --device cpu --decode-steps 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --smoke --device cpu --decode-steps 4

Hybrid archs raise ``--max-context`` to the meta tokens plus the SWA
window plus ``--max-new``, as the reference's CLI does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs import registry
from repro_torch.models import hybrid as H
from repro_torch.models.common import merge_instances
from repro_torch.serving import MultiModelServer, Request
from repro_torch.serving.scheduler import POLICIES


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(registry.PORTED))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no card and no --device raises)")
    ap.add_argument("--num-instances", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-context", type=int, default=128)
    ap.add_argument("--policy", choices=sorted(POLICIES), default="fifo")
    ap.add_argument("--chunk", type=int, default=32,
                    help="prefill chunk size (tokens per admission call)")
    ap.add_argument("--chunk-budget", type=int, default=4,
                    help="max prefill chunk calls interleaved per engine step")
    ap.add_argument("--lanes", type=int, default=4,
                    help="concurrent prefill lanes (requests mid-admission)")
    ap.add_argument("--decode-steps", type=int, default=1, metavar="K",
                    help="K decode+sample steps per dispatched block")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = api.resolve_device(args.device)
    base = registry.get_smoke_config(args.arch) if args.smoke else registry.get_config(args.arch)
    max_context = args.max_context
    if base.family == "hybrid":
        need = H.min_serving_context(base, args.max_new)
        if max_context < need:
            print(f"raising --max-context {max_context} -> {need} "
                  f"(hybrid meta tokens + SWA ring)")
            max_context = need
    m = args.num_instances
    cfg1 = base.with_(num_instances=1)
    cfg = base.with_(num_instances=m)

    # M independently "fine-tuned" instances (different random weights)
    with torch.inference_mode():
        instances = [
            api.init(cfg1, torch.Generator(device=device).manual_seed(args.seed * 1000 + i),
                     device)
            for i in range(m)
        ]
        t0 = time.perf_counter()
        merged = merge_instances(instances)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    del instances
    print(f"NetFuse merge of {m} instances: {(time.perf_counter() - t0) * 1e3:.1f} ms "
          f"on {device}")

    server = MultiModelServer(
        cfg, merged, slots_per_instance=args.slots, max_context=max_context,
        temperature=args.temperature, top_k=args.top_k, seed=args.seed,
        scheduler=args.policy, prefill_chunk=args.chunk, prefill_lanes=args.lanes,
        chunk_budget=args.chunk_budget, decode_steps=args.decode_steps, device=device,
    )
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(instance=i % m,
                prompt=rng.integers(1, cfg.vocab_size, size=rng.integers(2, 8)).tolist(),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]
    t0 = time.perf_counter()
    for r in reqs:
        server.submit(r)
    results = server.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in results)
    snap = server.metrics.snapshot()
    print(f"served {len(results)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, {snap['decode_steps']} decode steps in "
          f"{server.steps} blocks @ K={args.decode_steps}, "
          f"{snap['tokens_per_device_call']:.1f} tok/block, policy={args.policy})")
    print(f"chunked prefill: chunk={server.prefill.chunk}, "
          f"{server.prefill.device_calls} chunk calls for "
          f"{server.prefill.admitted} admissions")
    print(server.metrics.format_table())
    for r in sorted(results, key=lambda r: r.request_id)[:4]:
        print(f"  req {r.request_id} (instance {r.instance}): {r.tokens[:8]}...")


if __name__ == "__main__":
    main()
