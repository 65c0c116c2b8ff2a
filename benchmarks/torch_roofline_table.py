"""Achieved-vs-roofline table of the port's kernels (the ``--achieved``
mode of ``benchmarks/roofline_table.py``, for the PyTorch port on an
NVIDIA H100; the dry-run mode renders XLA results and has no port).

Times each kernel at ``--arch``'s shapes through ``kernels/ops.py`` and
prints achieved FLOP/s and bytes/s against the H100 roofline
(``repro_torch.serving.obs.kernel_profile``).  A serving architecture
profiles the seven serving kernels at its serving shapes; an encoder
(bert-base, xlnet-base) profiles the merged matmul and the per-instance
RMS norm at the paper's shapes (bs 1, sequence 128).  Runs on the card
unless ``--device cpu`` is given (then every row is the plain PyTorch
version, marked so); with no card and no such flag it raises.

  PYTHONPATH=src python benchmarks/torch_roofline_table.py --achieved \\
      [--arch tinyllama-1.1b] [--full] [--num-instances 4] [--slots 4] \\
      [--achieved-context 128] [--achieved-chunk 32] [--repeats 3] \\
      [--achieved-json out.json] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import api  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.obs import kernel_profile as kp  # noqa: E402


def achieved(args) -> list[dict]:
    """Time the kernels at --arch's shapes and print the table."""
    dev = api.resolve_device(args.device)
    cfg = registry.get_config(args.arch) if args.full else registry.get_smoke_config(args.arch)
    cfg = cfg.with_(num_instances=args.num_instances)
    ops.reset_launches()
    if cfg.family == "encoder":
        shapes = kp.paper_shapes(cfg)
        rows = [kp.profile_kernel(k, dtype=cfg.dtype, repeats=args.repeats, device=dev, **s)
                for k, s in shapes.items()]
    else:
        rows = kp.profile_serving_kernels(
            cfg, slots=args.slots, max_context=args.achieved_context,
            chunk=args.achieved_chunk, prefill_lanes=args.lanes, repeats=args.repeats,
            device=dev)
    kp.validate_profile(rows)
    print(kp.format_table(rows))
    print(f"\nkernel launches: {json.dumps(ops.launches())}")
    if rows[0]["plain"]:
        print("\n(plain PyTorch versions on the CPU: these figures characterise the host, "
              "not the card)")
    if args.achieved_json:
        with open(args.achieved_json, "w") as f:
            json.dump(rows, f, indent=2)
        print(f"wrote {args.achieved_json}")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--achieved", action="store_true",
                    help="measure the kernels (the only mode of the port)")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--full", action="store_true",
                    help="published config instead of the smoke config")
    ap.add_argument("--num-instances", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--achieved-context", type=int, default=128)
    ap.add_argument("--achieved-chunk", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--achieved-json", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    if not args.achieved:
        ap.error("the port has only the --achieved mode")
    achieved(args)


if __name__ == "__main__":
    main()
