#!/usr/bin/env python3
"""Does a lane's decode give the same bits whoever shares its call?

The data axis of a (data=D, model=T) serving mesh hands each rank a block
of the grid's instance rows, so a rank's decode runs over M / D instances
where one device runs over M.  A rank's streams equal one device's only
if no operation of the decode step gives a row other bits at another row
count.  For ``--arch`` at full width (``--layers`` cuts the depth), M = 4
seeded instances and B = 4 slots each:

1. state: a chunked prefill of random prompts fills the (M, B) grid, then
   ``--steps`` greedy decode steps run on the whole grid and, apart, on
   instance rows 0 and 1 alone (their weights and state rows); the tokens
   and every state leaf are compared bit for bit;
2. ops (``--ops``): one decode step under a ``TorchDispatchMode`` that
   records every aten op's output on the whole grid, then replays the
   step on rows 0 and 1 and reports each op whose rows differ, healing
   its output to the whole grid's so the next culprit shows on its own
   (a loop whose length follows M ends the comparison at its first op);
3. streams (``--mixes N``, CUDA only): N request mixes (16 requests of
   16-512 tokens, 32 new, K = 8, seeds 0 .. N - 1) served on one device
   and on a 2x1 mesh (two ranks on the card over gloo), each mix's
   streams counted equal.

  python benchmarks/torch_lane_bits.py --arch xlstm-1.3b --layers 16 --ops --mixes 3
  python benchmarks/torch_lane_bits.py --arch hymba-1.5b --smoke --device cpu --ops

Prints one ``[lane_bits]`` line per finding.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import mesh, serve  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.serving import MultiModelServer, Request  # noqa: E402

M, B, CHUNK, CONTEXT = 4, 4, 32, 1536
# ops whose outputs are fresh storage or aliases, not results
SKIP = ("empty", "new_empty", "empty_like", "empty_strided", "_local_scalar_dense",
        "lift_fresh", "detach", "alias")


def log(**kw):
    print("[lane_bits] " + ", ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def _where() -> str:
    fr = [f for f in traceback.extract_stack() if "repro_torch" in f.filename]
    return " < ".join(f"{os.path.basename(f.filename)}:{f.lineno}" for f in fr[::-1][:3])


def _rows(a, b):
    """``a``'s first rows along the one dim where it is twice ``b``."""
    if a.shape == b.shape:
        return a
    diff = [d for d in range(a.ndim) if a.shape[d] != b.shape[d]] if a.ndim == b.ndim else []
    if len(diff) == 1 and a.shape[diff[0]] == 2 * b.shape[diff[0]]:
        return a.narrow(diff[0], 0, b.shape[diff[0]])
    return None


def _bits_equal(a, b) -> bool:
    if a.dtype.is_floating_point and a.element_size() in (2, 4):
        view = torch.int16 if a.element_size() == 2 else torch.int32
        return torch.equal(a.contiguous().view(view), b.contiguous().view(view))
    return torch.equal(a, b)


class _Ops(TorchDispatchMode):
    """Records (``ref`` None) or compares against ``ref`` every aten op."""

    def __init__(self, ref=None):
        super().__init__()
        self.ref, self.outs, self.diffs, self.i, self.compared = ref, [], [], 0, 0
        self.diverged = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in SKIP or func.is_view:
            return out
        ts = [out] if isinstance(out, torch.Tensor) else [
            t for t in (out if isinstance(out, (tuple, list)) else []) if isinstance(t, torch.Tensor)]
        if self.ref is None:
            self.outs.append((name, [t.clone() for t in ts]))
            return out
        if self.i < 0:
            return out
        rname, rts = self.ref[self.i]
        self.i += 1
        if rname != name:
            self.diverged = f"{rname}/{name}@{_where()}"
            self.i = -1
            return out
        self.compared += 1
        for a, b in zip(rts, ts):
            s = _rows(a, b)
            if s is not None and not _bits_equal(s, b):
                err = (s.float() - b.float()).abs().max().item()
                self.diffs.append(f"{name} {tuple(b.shape)} {str(b.dtype)[6:]} "
                                  f"max_diff={err:.3e} at {_where()}")
                b.copy_(s)
        return out


def _grid(cfg, params, dev, seed: int):
    """The (M, B) grid's state after a chunked prefill of 5 chunks of random
    prompt tokens, and the token and position the first decode step takes."""
    carry = api.init_chunk_carry(cfg, M, B, CONTEXT, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    extra = {}
    if cfg.family == "vlm":
        extra["image_embeds"] = torch.zeros((M, B, cfg.num_image_patches, cfg.vision_embed_dim),
                                            dtype=getattr(torch, cfg.dtype), device=dev)
    if cfg.family == "audio":
        extra["frames"] = torch.zeros((M, B, cfg.num_audio_frames, cfg.d_model),
                                      dtype=getattr(torch, cfg.dtype), device=dev)
    with torch.inference_mode():
        for c in range(5):
            toks = torch.randint(1, cfg.vocab_size, (M, B, CHUNK), generator=g, device=dev,
                                 dtype=torch.int32)
            api.prefill_chunk(cfg, params, {"tokens": toks, **extra}, carry,
                              torch.full((M, B), CHUNK * c, dtype=torch.int32, device=dev))
    tok = torch.randint(1, cfg.vocab_size, (M, B, 1), generator=g, device=dev, dtype=torch.int32)
    return carry["cache"], tok, torch.full((M, B), 5 * CHUNK, dtype=torch.int32, device=dev)


def state_check(cfg, params, dev, steps: int, ops: bool) -> None:
    state, tok, pos = _grid(cfg, params, dev, 1)
    axes = api.cache_axes(cfg)
    half = C.tree_map_axes(lambda ax, l: l.narrow(ax.index("instances"), 0, 2).clone(),
                           axes, state)
    p2, c2 = C.instance_rows(params, 0, 2), cfg.with_(num_instances=2)
    alive = torch.ones((M, B), dtype=torch.bool, device=dev)
    if ops:
        outs = []
        for c_, p_, st, n in ((cfg, params, state, M), (c2, p2, half, 2)):
            rec = _Ops(outs[0].outs if outs else None)
            with torch.inference_mode(), rec:
                api.decode_step_sample(c_, p_, C.tree_map(lambda t: t.clone(), st), tok[:n],
                                       pos[:n], alive=alive[:n])
            outs.append(rec)
        rec = outs[1]
        where = {}
        for d in rec.diffs:
            key = d.split(" at ")[-1] + " " + d.split()[0]
            where[key] = where.get(key, 0) + 1
        log(arch=cfg.name, check="ops", ops_compared=rec.compared, ops_differing=len(rec.diffs),
            order_diverged_at=rec.diverged)
        for key, n in sorted(where.items(), key=lambda kv: -kv[1]):
            log(arch=cfg.name, check="ops", times=n, op=key)
    s4, s2 = (C.tree_map(lambda t: t.clone(), st) for st in (state, half))
    t4, t2, same = tok, tok[:2], 0
    with torch.inference_mode():
        for j in range(steps):
            n4, _ = api.decode_step_sample(cfg, params, s4, t4, pos + j, alive=alive)
            n2, _ = api.decode_step_sample(c2, p2, s2, t2, pos[:2] + j, alive=alive[:2])
            same += int(torch.equal(n4[:2], n2))
            t4, t2 = n4[..., None], n4[:2, :, None]
    bad = []
    C.tree_map_axes(lambda ax, a, b_: None if _bits_equal(
        a.narrow(ax.index("instances"), 0, 2), b_) else bad.append(ax), axes, s4, s2)
    log(arch=cfg.name, layers=cfg.num_layers, check="state", steps=steps,
        steps_with_equal_tokens=f"{same}/{steps}", state_leaves=len(C._leaves(s2)),
        state_leaves_differing=len(bad))


def _requests(cfg, seed: int) -> list[Request]:
    import numpy as np

    rng = np.random.default_rng(seed)
    return [Request(i % M, rng.integers(1, cfg.vocab_size, int(rng.integers(16, 513))).tolist(),
                    32) for i in range(16)]


def stream_check(cfg, dev, mixes: int) -> None:
    kw = dict(slots_per_instance=B, max_context=CONTEXT, prefill_chunk=CHUNK, prefill_lanes=4,
              decode_steps=8)
    single = []
    params = serve.random_merged(cfg, 0, dev)[0]
    for seed in range(mixes):
        srv = MultiModelServer(cfg, params, device=dev, **kw)
        for r in _requests(cfg, seed):
            srv.submit(r)
        res = srv.run_until_drained()
        # a failed chunk call ends its requests as "error" with no tokens
        assert all(r.status == "ok" for r in res), [(r.request_id, r.error) for r in res]
        single.append({r.request_id: r.tokens for r in res})
        del srv
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh.spawn(mesh.in_turn, 1, *[(serve.serve_rank, cfg, 0, _requests(cfg, s), kw)
                                          for s in range(mixes)], device="cuda", data=2)
    for seed in range(mixes):
        assert all(r[seed]["statuses"] == ["ok"] * len(single[seed]) for r in ranks)
        got = [r[seed]["streams"] for r in ranks]
        assert got[0] == got[1], "the two ranks' streams differ"
        same = sum(got[0][i] == single[seed][i] for i in single[seed])
        log(arch=cfg.name, layers=cfg.num_layers, check="streams", mix=seed, mesh="2x1",
            streams_equal_to_single_device=f"{same}/{len(single[seed])}")
    log(arch=cfg.name, check="streams", spawn_s=round(time.perf_counter() - t0, 1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(registry.PORTED))
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: the config's)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--ops", action="store_true", help="localise differing ops")
    ap.add_argument("--mixes", type=int, default=0, help="request mixes on 1 device and 2x1")
    args = ap.parse_args(argv)
    dev = api.resolve_device(args.device)
    cfg = (registry.get_smoke_config if args.smoke else registry.get_config)(args.arch)
    cfg = cfg.with_(num_instances=M, **({"num_layers": args.layers} if args.layers else {}))
    t0 = time.perf_counter()
    params = serve.random_merged(cfg, 0, dev)[0]
    state_check(cfg, params, dev, args.steps, args.ops)
    del params
    if args.mixes:
        if dev.type != "cuda":
            raise SystemExit("--mixes runs a 2x1 mesh on the card")
        torch.cuda.empty_cache()
        stream_check(cfg, dev, args.mixes)
    log(arch=cfg.name, seconds=round(time.perf_counter() - t0, 1))


if __name__ == "__main__":
    main()
