#!/usr/bin/env python3
"""Serve the same requests several times on one card and find the first
kernel call whose output differs between two runs.

  python3 benchmarks/torch_serve_determinism.py --arch olmoe-1b-7b --runs 6

``--arch`` at full width (``--layers`` cuts the depth), M = 4 seeded
instances, 4 slots each, chunk 32, 4 lanes, K = 8, the serve cells' mix of
16 requests (16-512 tokens, 32 new, greedy), served ``--runs`` times by
fresh servers on the same weights in one process.  Every kernel wrapper of
``kernels/ops.py`` is wrapped to record, on the card, a bit sum of each
tensor it reads and writes (the expert weights, over 2^27 elements and
constant, are left out).  For each run after the first: how many streams
equal the first run's, and the first call whose records differ, with
whether its inputs were equal (a kernel that gave other bits on equal
inputs) or not (something before it did).

Prints one ``[determinism]`` line per run.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import MultiModelServer, Request  # noqa: E402

M, B = 4, 4


def bit_sum(t: torch.Tensor) -> torch.Tensor:
    if t.numel() > 2 ** 27:
        return torch.zeros((), dtype=torch.int64, device=t.device)
    t = t.contiguous()
    view = {2: torch.int16, 4: torch.int32}.get(t.element_size())
    return torch.sum(t.view(view) if view else t, dtype=torch.int64)


def tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in tensors(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for y in x for v in tensors(y)]
    return []


def record(calls: list) -> None:
    """Wrap every kernel's launcher to append (name, input sums, output sums)."""
    for k in ops.KERNELS:
        def run(*a, _fn=k.cuda, _name=k.name, **kw):
            ins = torch.stack([bit_sum(t) for t in tensors(a) + tensors(kw)])
            out = _fn(*a, **kw)
            outs = torch.stack([bit_sum(t) for t in tensors(out) + tensors(a)])
            calls.append((_name, ins, outs))
            return out
        k.cuda = run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(registry.PORTED))
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    cfg = registry.get_config(args.arch).with_(num_instances=M)
    if args.layers:
        cfg = cfg.with_(num_layers=args.layers)
    kw = dict(slots_per_instance=B, max_context=1536 if cfg.family == "hybrid" else 1024,
              prefill_chunk=32, prefill_lanes=4, decode_steps=8)
    rng = np.random.default_rng(0)
    mix = [(i % M, rng.integers(1, cfg.vocab_size, int(rng.integers(16, 513))).tolist())
           for i in range(16)]
    params = serve.random_merged(cfg, 0, dev)[0]
    calls: list = []
    record(calls)
    runs = []
    for _ in range(args.runs):
        calls.clear()
        srv = MultiModelServer(cfg, params, device=dev, **kw)
        for inst, prompt in mix:
            srv.submit(Request(inst, list(prompt), 32))
        res = srv.run_until_drained()
        # a failed chunk call ends its requests as "error" with no tokens
        assert all(r.status == "ok" for r in res), [(r.request_id, r.error) for r in res]
        streams = {r.request_id: r.tokens for r in res}
        runs.append((streams, [(n, a.cpu(), b.cpu()) for n, a, b in calls]))
        del srv
    s0, c0 = runs[0]
    for i, (s, c) in enumerate(runs[1:], 1):
        line = (f"[determinism] arch={cfg.name}, layers={cfg.num_layers}, run={i}, "
                f"streams_equal_to_run_0={sum(s0[j] == s[j] for j in s0)}/{len(s0)}, "
                f"kernel_calls={len(c)}")
        first = next((j for j, (a, b) in enumerate(zip(c0, c))
                      if not (torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]))), None)
        if first is not None:
            a, b = c0[first], c[first]
            line += (f", first_differing_call={first} ({a[0]}), "
                     f"its_inputs_equal={torch.equal(a[1], b[1])}")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
