"""Serving-strategy baselines of the paper's evaluation (port of
``repro.core.baselines``; paper section 5.1).

The paper compares NetFuse with three ways of running M models on one
GPU.  On the card they are what the paper ran:

* ``sequential``  -- the M instances one after another on one stream;
* ``concurrent``  -- one forward per instance, each on its own CUDA
  stream, joined by events (the paper's M concurrent streams); on CPU
  tensors they run in order;
* ``hybrid(P)``   -- ceil(M / P) rounds of P concurrent streams;
* ``netfuse``     -- merge the M instances on their instances axis and
  run the merged forward once (the paper's technique).

Each instance is a model of the port's layout with one instance
(``models.common.instance_views`` of a merged model, or a checkpoint of
M=1); its input is the instance's (B, ...) slice.  All return the
per-instance outputs in instance order, so the strategies can be held
against each other.  ``benchmarks/torch_run.py`` times these functions.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Sequence

import torch

from repro_torch.models import common as C

Tree = Any
ApplyFn = Callable[..., torch.Tensor]     # apply(params with M axis, x with M axis)


def _single(apply_fn: ApplyFn, params: Tree, x: torch.Tensor) -> torch.Tensor:
    """One M=1 instance through the fusion-aware apply, M dropped."""
    return apply_fn(params, x[None])[0]


@functools.lru_cache(maxsize=None)
def _stream_pool(device: torch.device, n: int) -> tuple:
    return tuple(torch.cuda.Stream(device) for _ in range(n))


def _record(out, stream) -> None:
    """Mark every tensor of ``out`` as used on ``stream``, so the caching
    allocator does not hand its memory to another stream's work early."""
    if isinstance(out, torch.Tensor):
        out.record_stream(stream)
    elif isinstance(out, (list, tuple)):
        for o in out:
            _record(o, stream)
    elif isinstance(out, dict):
        for o in out.values():
            _record(o, stream)


def on_streams(thunks: Sequence[Callable[[], Any]], device) -> list:
    """Run each thunk on its own CUDA stream of ``device`` and join them on
    the current stream (the paper's concurrent execution).  Each stream
    first waits for the current stream, so inputs made there are ready;
    each result is marked as used on the current stream.  On the CPU the
    thunks run in order."""
    device = torch.device(device)
    if device.type != "cuda":
        return [t() for t in thunks]
    main = torch.cuda.current_stream(device)
    streams = _stream_pool(device, len(thunks))
    ready = main.record_event()
    outs = []
    for t, s in zip(thunks, streams):
        s.wait_event(ready)
        with torch.cuda.stream(s):
            outs.append(t())
        main.wait_stream(s)
    for o in outs:
        _record(o, main)
    return outs


def sequential(apply_fn: ApplyFn, params_list: Sequence[Tree],
               inputs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The M instances one after another."""
    return [_single(apply_fn, p, x) for p, x in zip(params_list, inputs)]


def concurrent(apply_fn: ApplyFn, params_list: Sequence[Tree],
               inputs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """One forward per instance, each on its own CUDA stream."""
    return on_streams([functools.partial(_single, apply_fn, p, x)
                       for p, x in zip(params_list, inputs)], inputs[0].device)


def hybrid(apply_fn: ApplyFn, params_list: Sequence[Tree], inputs: Sequence[torch.Tensor], *,
           num_concurrent: int) -> list[torch.Tensor]:
    """ceil(M / P) rounds of P concurrent streams (paper section 5.3)."""
    out: list[torch.Tensor] = []
    p = num_concurrent
    for i in range(0, len(params_list), p):
        out.extend(concurrent(apply_fn, params_list[i:i + p], inputs[i:i + p]))
    return out


def netfuse(apply_fn: ApplyFn, params_list: Sequence[Tree],
            inputs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The paper's technique: merge, then run the merged forward once."""
    merged = C.merge_instances(list(params_list))
    out = apply_fn(merged, torch.stack(list(inputs)))
    return [out[i] for i in range(len(params_list))]


def netfuse_premerged(apply_fn: ApplyFn, merged_params: Tree, x: torch.Tensor) -> torch.Tensor:
    """The steady-state merged call (merging is offline, paper section 4)."""
    return apply_fn(merged_params, x)


STRATEGIES = {
    "sequential": sequential,
    "concurrent": concurrent,
    "netfuse": netfuse,
}
