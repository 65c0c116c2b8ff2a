"""Rank programs that hold the mesh paths against the single-device
one: targets of ``mesh.spawn``, run by the tests on the CPU and by
``chip_smoke.py`` on the card.  Each takes the whole model or problem
(``chunk_decode_rank``: a dense or moe model; ``fused_matmul_rank``: a seeded
matmul), cuts its rank's share and returns what it computed, on the CPU.
The hybrid and ssm families under tensor parallelism and every family on
the data axis are held through ``launch/serve.serve_rank``'s streams.
"""
from __future__ import annotations

import time

import torch

from repro_torch import api
from repro_torch.kernels import fused_matmul as fm
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models.common import tree_map
from repro_torch.models.shardings import shard, shard_params


def chunk_decode_rank(tp, cfg, params, tokens, width: int, ctx: int) -> dict:
    """Prefill ``tokens`` (M, B, n) in chunks of ``width`` from a fresh
    carry of context ``ctx`` (moe: at the exact-length capacity of n
    tokens), then a greedy decode step and a decode step at position n.  Returns this rank's cache shard after the prefill
    (k, v), the decode step's logits (M, B, V), gathered over the ranks,
    and the greedy tokens (M, B)."""
    dev = tp.device
    with torch.inference_mode():
        p = shard_params(cfg, params, tp.rank, tp.size).to(dev)
        m, b, n = tokens.shape
        carry = api.init_chunk_carry(cfg, m, b, ctx, device=dev, tp=tp)
        extra = {}
        if cfg.family == "moe":       # the exact-length capacity of the n tokens
            extra["moe_limit"] = torch.full((m, b), moe.capacity(cfg, n), dtype=torch.int32,
                                            device=dev)
        for start in range(0, n, width):
            off = torch.full((m, b), start, dtype=torch.int32, device=dev)
            api.prefill_chunk(cfg, p, {"tokens": tokens[:, :, start:start + width].to(dev),
                                       **extra}, carry, off, tp=tp)
        cache = carry["cache"]
        out = {"k": cache.k.cpu().clone(), "v": cache.v.cpu().clone()}
        pos = torch.full((m, b), n, dtype=torch.int32, device=dev)
        last = tokens[:, :, -1:].to(dev)
        nxt, _ = api.decode_step_sample(cfg, p, tree_map(lambda t: t.clone(), cache), last, pos,
                                        tp=tp)
        logits, _ = api.decode_step(cfg, p, cache, last, pos, tp=tp)
    return dict(out, logits=logits.cpu(), tokens=nxt.cpu())


def logits_rank(tp, x, scale, head) -> torch.Tensor:
    """Greedy tokens of ``logits_sample_sharded`` over this rank's vocab
    slice of ``head`` (M, D, V), which splits over the ranks."""
    dev = tp.device
    local = shard(head, 2, tp.rank, tp.size).to(dev)
    return ops.logits_sample_sharded(x.to(dev), scale.to(dev), local, tp=tp).cpu()


def all_reduce_rank(tp, shape, reps: int) -> float:
    """Milliseconds per ``all_reduce_sum`` of a bf16 tensor of ``shape``
    on this rank's device: host clock around ``reps`` calls that end in a
    device synchronisation.  The cost of one row-split projection's sum."""
    t = torch.ones(shape, dtype=torch.bfloat16, device=tp.device)
    tp.all_reduce_sum(t)
    if tp.device.type == "cuda":
        torch.cuda.synchronize(tp.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        tp.all_reduce_sum(t)
    if tp.device.type == "cuda":
        torch.cuda.synchronize(tp.device)
    return (time.perf_counter() - t0) * 1e3 / reps


def matmul_problem(seed: int, m: int, t: int, d: int, f: int, dtype, bias: bool):
    """A seeded whole problem of ``fused_matmul``, on the CPU: x (M, T, D)
    and w (M, D, F) scaled by D^-1/2 in ``dtype``, b (M, F) f32 or None.
    The same seed gives the same problem in every process."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, t, d, generator=g).to(dtype)
    w = (torch.randn(m, d, f, generator=g) * d ** -0.5).to(dtype)
    return x, w, torch.randn(m, f, generator=g) if bias else None


def fused_matmul_rank(tp, problem: tuple) -> dict:
    """Cut this rank's block of ``matmul_problem(*problem)`` and run
    ``ops.fused_matmul_sharded`` on it with every launch counter set to 0
    just before: the output block on the CPU and the wrapper's launches."""
    data = tp.data
    x, w, b = fm.rank_block(*matmul_problem(*problem), data.rank, data.size, tp.rank, tp.size)
    dev = tp.device
    x, w, b = x.to(dev), w.to(dev), None if b is None else b.to(dev)
    ops.reset_launches()
    with torch.inference_mode():
        out = ops.fused_matmul_sharded(x, w, b, data=data, tp=tp)
    return {"out": out.cpu(), "launches": ops.launches()["fused_matmul_sharded"]}


def data_gather_rank(tp, shape, reps: int) -> float:
    """Milliseconds per gather of an int32 host tensor of ``shape`` over
    this rank's data group: the engine's gather of a K-step block's tokens
    and emitted flags, host clock around ``reps`` gathers."""
    t = torch.zeros(shape, dtype=torch.int32)
    tp.data.all_gather(t, 2)
    t0 = time.perf_counter()
    for _ in range(reps):
        tp.data.all_gather(t, 2)
    return (time.perf_counter() - t0) * 1e3 / reps
