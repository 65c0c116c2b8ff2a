#!/usr/bin/env python3
"""Time the merged-matmul kernel's launch configurations on the card: the
evidence behind ``fused_matmul.launch_plan``'s choices.

  python3 benchmarks/torch_matmul_sweep.py

For each shape, bf16 without bias, the kernel runs as the plan says and
with the plan's column width or split replaced (``fused_matmul.launch``
takes any valid plan): the wide variant at 128 and 256 columns, the
skinny variant with D split 1 to 8 ways.  Each configuration: device time
per call, 40 calls queued behind a ~10 ms spin kernel, 8 weight sets
rotating so that w comes from HBM; ``torch.bmm`` on the same inputs
beside it.  Every output is checked against the plain version.  Prints
one line per shape, ``SWEEP {"shape": ..., "plan": ..., "ms": {...},
"bmm_ms": ...}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

WIDE = ((32, 128, 768, 3072), (16, 128, 768, 1536), (3, 77, 768, 3072))
SKINNY = ((4, 4, 2048, 5632), (2, 4, 2048, 2816), (1, 4, 2048, 1024), (1, 16, 4096, 2048))


def main() -> int:
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    import torch

    if not torch.cuda.is_available():
        print("torch_matmul_sweep: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import fused_matmul as fm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def queued(fn, reps=40):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    for shape in WIDE + SKINNY:
        m, t, d, f = shape
        sets = [(torch.randn(m, t, d, generator=g, device=dev).bfloat16(),
                 (torch.randn(m, d, f, generator=g, device=dev) * d ** -0.5).bfloat16())
                for _ in range(8)]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = fm.launch_plan(*shape, sms=sms)
        if plan.variant == "wide":
            plans = {f"cols{c}": dataclasses.replace(
                plan, cols=c, grid=(min(m * -(-t // fm.WIDE_ROWS) * -(-f // c), sms), 1, 1))
                for c in (128, 256)}
        else:
            steps = -(-d // fm.HK)
            plans = {f"split{s}": dataclasses.replace(plan, split=s, grid=(plan.grid[0], s, m))
                     for s in range(1, min(fm.MAX_SPLIT, steps) + 1)}
        ms = {}
        for name, p in plans.items():
            got = fm.launch(*sets[0], None, p)
            err = (got.float() - fm.fused_matmul_plain(*sets[0]).float()).abs().max().item()
            assert err <= 3e-2 * max(1.0, fm.fused_matmul_plain(*sets[0]).float().abs().max().item())
            it = iter(range(10 ** 9))
            ms[name] = queued(lambda: fm.launch(*sets[next(it) % 8], None, p))
        it = iter(range(10 ** 9))
        bmm = queued(lambda: torch.bmm(*sets[next(it) % 8]))
        print("SWEEP " + json.dumps({"shape": shape, "plan": dataclasses.asdict(plan), "ms": ms,
                                     "bmm_ms": bmm, "card": torch.cuda.get_device_name(0)}),
              flush=True)
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
