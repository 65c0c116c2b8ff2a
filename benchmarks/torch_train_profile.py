#!/usr/bin/env python3
"""Where a training step of the port spends its time, on the card.

  PYTHONPATH=src python benchmarks/torch_train_profile.py --arch xlstm-1.3b \\
      --instances 2 --batch 1 --seq 256
  PYTHONPATH=src python benchmarks/torch_train_profile.py --arch tinyllama-1.1b \\
      --instances 2 --batch 2 --seq 512
  PYTHONPATH=src python benchmarks/torch_train_profile.py --arch olmoe-1b-7b \\
      --instances 2 --batch 1 --seq 512 --layers 4
  PYTHONPATH=src python benchmarks/torch_train_profile.py --arch xlstm-1.3b \\
      --smoke --device cpu            # a dry run on the CPU: no device numbers

Builds the trainable merged model (f32 masters from a seed), takes
``--warmup`` AdamW steps on one fixed batch of ``pipeline.make_batch``
(vlm's patch embeddings and audio's frames with the tokens), then times
``--steps`` steps split into the loss (forward), ``backward`` and the
AdamW update, each ended by a synchronise (host clock), and profiles one
more step with ``torch.profiler``: the device busy time of that step,
kernels launched, and the ops with the most device time and the most host
time.  The idle share is the busy time over the unprofiled median step
(``device_idle_share``): the profiler's CPU-op recording stretches the
profiled step's wall several times, so its own idle share
(``profiled_step_idle_share``) measures mostly the profiler.  Prints the card's name and power limit beside the numbers.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


def device_us(e):
    """An event's own device time in us."""
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0.0))


def busy_s(prof) -> float:
    """Seconds in which at least one kernel ran (union of device events)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def main(argv=None):
    from repro_torch import api
    from repro_torch.configs import registry
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw_update, constant
    from repro_torch.train import loop

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=0, help="cut the depth")
    ap.add_argument("--lr", type=float, default=3e-5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=14)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    dev = api.resolve_device(args.device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)
    cfg = registry.get_smoke_config(args.arch) if args.smoke else registry.get_config(args.arch)
    cfg = cfg.with_(num_instances=args.instances)
    if args.layers:
        cfg = cfg.with_(num_layers=args.layers)
    state = loop.init_state(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = pipeline.make_batch(cfg, 0, args.batch, args.seq, device=dev)
    step_fn = loop.make_train_step(cfg, lr_schedule=constant(args.lr))
    for _ in range(args.warmup):
        state, _ = step_fn(state, batch)
    sync()

    params, opt = state
    parts = {"forward": [], "backward": [], "adamw": []}
    for _ in range(args.steps):
        t0 = time.perf_counter()
        loss, _ = api.loss_fn(cfg, params, batch)
        sync()
        t1 = time.perf_counter()
        loss.backward()
        sync()
        t2 = time.perf_counter()
        params, opt, _ = adamw_update(params.tree("grad"), opt, params, lr=args.lr)
        params.zero_grad(set_to_none=True)
        sync()
        t3 = time.perf_counter()
        for k, a, b in (("forward", t0, t1), ("backward", t1, t2), ("adamw", t2, t3)):
            parts[k].append(1e3 * (b - a))
    med = {k: sorted(v)[len(v) // 2] for k, v in parts.items()}
    tokens = cfg.num_instances * args.batch * args.seq
    step_ms = sum(med.values())
    print(json.dumps({"arch": cfg.name, "instances": cfg.num_instances, "layers": cfg.num_layers,
                      "batch": args.batch, "seq": args.seq, "device": str(dev),
                      "ms": {k: round(v, 1) for k, v in med.items()},
                      "step_ms": round(step_ms, 1),
                      "tok_per_s": round(tokens / step_ms * 1e3, 1)}), flush=True)
    if not cuda:
        print("device numbers: not measured (CPU run)")
        return
    from torch.profiler import ProfilerActivity, profile

    state = loop.TrainState(params, opt)
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        sync()
        wall = time.perf_counter() - t0
    busy = busy_s(prof)
    ev = prof.key_averages()
    kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    print(json.dumps({"profiled_step_s": round(wall, 3), "device_busy_s": round(busy, 3),
                      "device_idle_share": round(1 - busy / (step_ms / 1e3), 3),
                      "profiled_step_idle_share": round(1 - busy / wall, 3),
                      "device_kernels": len(kernels),
                      "launches": {k: v for k, v in ops.launches().items() if v}}), flush=True)
    for title, key in (("device", device_us), ("host", lambda e: e.self_cpu_time_total)):
        print(f"top ops by self {title} time (ms total, calls):")
        for e in sorted(ev, key=key, reverse=True)[:args.top]:
            print(f"  {e.key[:70]:70s} {key(e) / 1e3:10.2f} {e.count:7d}")


if __name__ == "__main__":
    main()
