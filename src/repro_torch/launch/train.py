"""Training launcher (port of ``repro.launch.train``): trains M merged
instances of one architecture on synthetic data, on the CUDA device
unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --smoke --device cpu --steps 100 --batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b \\
      --num-instances 2 --steps 4 --batch 1 --seq 256
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
      --smoke --device cpu --num-instances 2 --steps 3 --batch 2 --seq 16

All six families train (moe adds its router's aux loss; vlm's batches
carry stub patch embeddings, audio's stub frames).  ``--save
DIR`` writes the trained merged model with ``checkpoint/store.save`` in
the reference's format (the JAX package's ``checkpoint.restore`` reads
it).  ``--mesh`` (data-parallel training) is not ported yet and raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import api
from repro_torch.checkpoint import store
from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.optim import cosine_with_warmup
from repro_torch.train import loop as train_loop


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(registry.ASSIGNED))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--num-instances", type=int, default=1,
                    help="NetFuse-merge M instances and train them together")
    ap.add_argument("--save", default=None, help="checkpoint dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", action="store_true",
                    help="data-parallel training (not ported yet: raises)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' to run on the CPU)")
    # size overrides (e.g. a ~100M CPU run: --arch tinyllama-1.1b --smoke
    # --layers 8 --d-model 768 --heads 12 --kv-heads 4 --d-ff 2048 --vocab 32000)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--heads", type=int, default=0)
    ap.add_argument("--kv-heads", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "data-parallel training is not ported yet (ROADMAP.md Queue 1: "
            "data-parallel training, --mesh)")
    dev = api.resolve_device(args.device)
    cfg = registry.get_smoke_config(args.arch) if args.smoke else registry.get_config(args.arch)
    cfg = cfg.with_(num_instances=args.num_instances)
    over = {k: v for k, v in (
        ("num_layers", args.layers), ("d_model", args.d_model),
        ("num_heads", args.heads), ("num_kv_heads", args.kv_heads),
        ("d_ff", args.d_ff), ("vocab_size", args.vocab),
    ) if v}
    if over:
        if "d_model" in over:
            over.setdefault("head_dim", 0)  # recompute from new dims
        cfg = cfg.with_(**over)
    print(f"arch={cfg.name} family={cfg.family} M={cfg.num_instances} device={dev}")

    sched = cosine_with_warmup(args.lr, warmup_steps=args.steps // 10 + 1,
                               total_steps=args.steps)
    data = lambda step: pipeline.make_batch(cfg, step, args.batch, args.seq, seed=17)
    t0 = time.perf_counter()
    state, losses = train_loop.train_loop(
        cfg, data, steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        lr_schedule=sched, generator=torch.Generator(device=dev).manual_seed(args.seed),
        device=dev)
    api.settle(dev)
    print(f"done in {time.perf_counter() - t0:.1f}s; "
          f"loss {losses[0][1]:.3f} -> {losses[-1][1]:.3f}")
    if args.save:
        store.save(args.save, state.params, extra={"arch": cfg.name, "steps": args.steps})
        print(f"saved params to {args.save}")
    return state, losses


if __name__ == "__main__":
    main()
