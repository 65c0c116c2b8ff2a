#!/usr/bin/env python3
"""Compare two checkouts' model glue (the code around the kernels) on one
card in one run: the time of a greedy decode step, or of a serve.

  python3 benchmarks/torch_decode_step_ab.py --roots PARENT CHANGE \\
      --arch hymba-1.5b [--layers N] [--pairs 10] [--steps 20] [--serve]

Each ROOT is the root of a checkout whose ``src/repro_torch`` is imported
(its kernels build into ROOT/build/kernels).  One worker process per
checkout builds the model once and stays alive, the two sharing the card;
only one works at a time.  The runs alternate A B B A A B ... for
``--pairs`` pairs, so a drift of the card or the host falls on both.

At full width (``--layers`` cuts the depth), M = 4 seeded instances and
B = 4 slots each.  A run is, by default, ``--steps`` greedy decode steps
(``api.decode_step_sample``, every lane alive, after a chunked prefill of
5 chunks of 32 random tokens and 3 warm-up steps), each timed on the host
clock up to a device synchronisation; its figure is the median step.
Beside it, ``host_cpu_ms``: the mean CPU time of the calling thread
while a step is dispatched (before the synchronisation), which other
processes on the host move far less than they move the wall clock (the
thread clock may tick in 10 ms: the mean over the run resolves it).
With ``--serve`` a run serves 16 requests of 16-512 tokens, 32 new,
greedy, K = 8, chunk 32, 4 lanes (the mix of ``chip_smoke.py``'s serve
phase) and its figure is the decode ms per step of that run.

Prints one ``AB {...}`` line per run and an ``AB_SUMMARY {...}`` line: the
median of each checkout's run figures and of the per-pair ratios B / A.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

M, B, C = 4, 4, 32


def _worker(args) -> int:
    sys.path.insert(0, os.path.join(os.path.abspath(args.worker), "src"))
    import torch

    with torch.inference_mode():
        return _work(args, torch)


def _work(args, torch) -> int:
    from repro_torch import api
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.serving import MultiModelServer, Request

    dev = torch.device(args.device)
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch)).with_(num_instances=M)
    if args.layers:
        cfg = cfg.with_(num_layers=args.layers)
    params = serve.random_merged(cfg, 0, dev)[0]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if args.serve:
        import numpy as np

        ctx = 1536 if cfg.family == "hybrid" else 1024
        srv = MultiModelServer(cfg, params, device=dev, slots_per_instance=B, max_context=ctx,
                               prefill_chunk=C, prefill_lanes=4, decode_steps=8)
        rng = np.random.default_rng(0)
        reqs = [(i % M, rng.integers(1, cfg.vocab_size, int(rng.integers(16, 513))).tolist())
                for i in range(16)]

        def run():
            before = srv.metrics.snapshot()
            for inst, prompt in reqs:
                srv.submit(Request(inst, prompt, 32))
            srv.run_until_drained()
            sync()
            after = srv.metrics.snapshot()
            steps = after["decode_steps"] - before["decode_steps"]
            ms = (after["decode_ms_per_step"] * after["decode_steps"]
                  - before["decode_ms_per_step"] * before["decode_steps"]) / steps
            return {"decode_steps": steps, "ms": round(ms, 3)}
    else:
        g = torch.Generator(device=dev).manual_seed(1)
        carry = api.init_chunk_carry(cfg, M, B, 1536, device=dev)
        for i in range(5):
            toks = torch.randint(1, cfg.vocab_size, (M, B, C), generator=g, device=dev,
                                 dtype=torch.int32)
            api.prefill_chunk(cfg, params, {"tokens": toks}, carry,
                              torch.full((M, B), C * i, dtype=torch.int32, device=dev))
        cache = carry["cache"]
        alive = torch.ones((M, B), dtype=torch.bool, device=dev)
        state = {"tok": torch.randint(1, cfg.vocab_size, (M, B, 1), generator=g, device=dev,
                                      dtype=torch.int32), "pos": 5 * C}

        def step():
            pos = torch.full((M, B), state["pos"], dtype=torch.int32, device=dev)
            sync()
            t0, c0 = time.perf_counter(), time.thread_time()
            nxt, _ = api.decode_step_sample(cfg, params, cache, state["tok"], pos, alive=alive)
            c1 = time.thread_time()
            sync()
            state["tok"], state["pos"] = nxt[..., None], state["pos"] + 1
            return 1e3 * (time.perf_counter() - t0), 1e3 * (c1 - c0)

        for _ in range(3):
            step()

        def run():
            times, cpu = zip(*(step() for _ in range(args.steps)))
            return {"ms_per_step": [round(t, 3) for t in times],
                    "ms": round(statistics.median(times), 3),
                    "host_cpu_ms": round(statistics.fmean(cpu), 3)}
    print("READY " + json.dumps({"layers": cfg.num_layers}), flush=True)
    for line in sys.stdin:
        if line.strip() != "run":
            break
        print("RESULT " + json.dumps(run()), flush=True)
    return 0


def _read(proc, key: str) -> dict:
    for line in proc.stdout:
        if line.startswith(key + " "):
            return json.loads(line[len(key) + 1:])
        sys.stdout.write(line)
    raise RuntimeError(f"worker exited (rc {proc.wait()}) before {key}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs=2, metavar=("A", "B"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--smoke", action="store_true", help="the smoke config (a dry run)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.worker:
        return _worker(args)
    common = ["--arch", args.arch, "--layers", str(args.layers), "--steps", str(args.steps)]
    common += ["--device", args.device] + ["--serve"] * args.serve + ["--smoke"] * args.smoke
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", root,
                               *common], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              text=True) for root in args.roots]
    try:
        layers = [_read(p, "READY")["layers"] for p in procs][0]
        figs, cpu = {0: [], 1: []}, {0: [], 1: []}
        for i in range(args.pairs):
            for w in ((0, 1) if i % 2 == 0 else (1, 0)):
                procs[w].stdin.write("run\n")
                procs[w].stdin.flush()
                out = _read(procs[w], "RESULT")
                figs[w].append(out["ms"])
                cpu[w].append(out.get("host_cpu_ms"))
                print("AB " + json.dumps({"root": args.roots[w], "pair": i, "arch": args.arch,
                                          "layers": layers, **out}), flush=True)
    finally:
        for p in procs:
            p.stdin.close()
            p.wait(timeout=120)
    ratios = [b / a for a, b in zip(figs[0], figs[1])]
    print("AB_SUMMARY " + json.dumps({
        "arch": args.arch, "layers": layers, "mode": "serve" if args.serve else "decode_step",
        "pairs": args.pairs, "a": args.roots[0], "b": args.roots[1],
        "a_ms": figs[0], "b_ms": figs[1],
        "a_median_ms": round(statistics.median(figs[0]), 3),
        "b_median_ms": round(statistics.median(figs[1]), 3),
        "ratio_b_over_a_median": round(statistics.median(ratios), 4),
        "pairs_b_slower": sum(r > 1 for r in ratios),
        **({} if args.serve else {
            "a_host_cpu_median_ms": round(statistics.median(cpu[0]), 3),
            "b_host_cpu_median_ms": round(statistics.median(cpu[1]), 3),
            "pairs_b_more_host_cpu": sum(b > a for a, b in zip(cpu[0], cpu[1]))})}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
