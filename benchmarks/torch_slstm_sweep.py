#!/usr/bin/env python3
"""Time the sLSTM cell's ring configurations on the card: the evidence
behind ``slstm_cell.launch_plan``'s decode ring.

  python3 benchmarks/torch_slstm_sweep.py

At xlstm-1.3b's decode shape (M=4 rows of B=4 lanes, S=1, 4 heads of
512, f32 r, bf16 pre), where every row of r streams through the ring
once, the kernel runs as the plan says and with the plan's stage size
and depth replaced (``slstm_cell.launch`` takes any valid plan).  Each
configuration: device time per call, 40 calls queued behind a ~10 ms
spin kernel, 2 input sets rotating so that r comes from HBM; its output
is checked against the plain version.  Rings deeper than ~78 KB take a
block past half an SM's shared memory: one block an SM, and 15 of the
16 clusters resident.  Prints one line, ``SWEEP {"plan": ..., "ms":
{"ROWSxSTAGES": ...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

CONFIGS = ((16, 2), (16, 4), (32, 2), (32, 3), (64, 2), (16, 8), (8, 8))


def main() -> int:
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    import torch

    if not torch.cuda.is_available():
        print("torch_slstm_sweep: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import slstm_cell as sc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    m, b, h, hd = 4, 4, 4, 512
    d = h * hd

    def inputs():
        state = (torch.randn(m, b, d, generator=g, device=dev),
                 torch.rand(m, b, d, generator=g, device=dev) + 0.5,
                 (0.5 * torch.randn(m, b, d, generator=g, device=dev)).to(torch.bfloat16),
                 torch.randn(m, b, d, generator=g, device=dev))
        return (torch.randn(m, b, 1, 4, d, generator=g, device=dev).to(torch.bfloat16),
                torch.randn(m, 4, h, hd, hd, generator=g, device=dev) / hd ** 0.5, state)

    sets = [inputs() for _ in range(2)]
    base = sc.launch_plan(m, b, 1, h, hd, "float32")
    res = {}
    for rows, stages in CONFIGS:
        plan = dataclasses.replace(base, stage_rows=rows, stages=stages)
        pre, r, state = sets[0]
        got = sc.launch(pre, r, tuple(t.clone() for t in state), h, None, None, plan)[0]
        want = sc.slstm_cell_plain(pre, r, tuple(t.clone() for t in state), num_heads=h)[0]
        torch.cuda.synchronize()
        err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
        assert err <= 3e-2, (rows, stages, err)
        it = iter(range(10 ** 9))
        call = lambda: (lambda s: sc.launch(s[0], s[1], s[2], h, None, None, plan))(
            sets[next(it) % 2])
        call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(40):
            call()
        end.record()
        torch.cuda.synchronize()
        res[f"{rows}x{stages}"] = start.elapsed_time(end) / 40
    print("SWEEP " + json.dumps({"plan": f"{base.stage_rows}x{base.stages}", "ms": res,
                                 "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
