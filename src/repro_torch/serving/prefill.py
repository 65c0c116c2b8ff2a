"""Chunked prefill for serving admission (port of
``repro.serving.prefill``, dense family, single device).

Every prompt streams through ``api.prefill_chunk`` in fixed-size chunks;
the final partial chunk is padded and masked per position (tail
folding), so a lane batch drains in ``ceil(L_max / chunk)`` chunk calls.
Up to ``lanes`` requests prefill together in ONE carry, each lane reading
its own fine-tune's weights through views (``instances=``), at its own
offset.  The engine grants a per-step chunk budget, so prefill work
interleaves with decode.

The reference re-initialises ``fresh`` lanes and keeps non-working
lanes unchanged by selecting between carry trees.  The port's carry is
updated in place: a fresh lane's rows are zeroed before the call, and a
lane that does not advance gets an all-False per-position ``valid`` mask,
so none of its rows reach the cache.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import api
from repro_torch.serving.scheduler import Request

DEFAULT_CHUNK = 32
DEFAULT_LANES = 4


@dataclasses.dataclass
class PrefillOut:
    """One admitted request's prefill product: row ``index`` of the
    shared carry's cache.  The engine scatters it into the request's grid
    slot and seeds decode at ``pos`` with ``last_token`` (the last prompt
    token is decoded by the first grid step)."""
    cache: Any
    index: int
    pos: int
    last_token: int


@dataclasses.dataclass
class _Lane:
    req: Request | None = None
    next_pos: int = 0          # next absolute position to process
    total: int = 0             # positions to prefill = len(prompt) - 1
    fresh: bool = False        # carry rows need re-init before first work


class ChunkedPrefill:
    def __init__(self, cfg, *, max_context: int, device, chunk: int = DEFAULT_CHUNK,
                 lanes: int = DEFAULT_LANES, metrics=None):
        if cfg.family != "dense":
            raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
        self.cfg = cfg
        self.device = torch.device(device)
        self.max_context = max_context
        self.metrics = metrics
        self.lanes = max(1, lanes)
        # a chunk must map to distinct cache slots: clamp it to the ring
        ring = cfg.sliding_window
        self.chunk = max(1, min(chunk, ring if ring else chunk))
        self.prefix = api.prefill_prefix_len(cfg)
        if self.max_prompt_len() <= 0:
            raise ValueError(f"max_context={max_context} leaves no room for a prompt")
        self._carry = api.init_chunk_carry(cfg, self.lanes, 1, max_context, self.device)
        self._lanes = [_Lane() for _ in range(self.lanes)]
        self.device_calls = 0               # chunk calls
        self.admitted = 0                   # lanes ever started

    def max_prompt_len(self) -> int:
        return self.max_context - self.prefix

    # -- lane bookkeeping ----------------------------------------------------

    def free_lanes(self) -> int:
        return sum(1 for l in self._lanes if l.req is None)

    def in_flight(self) -> int:
        return sum(1 for l in self._lanes if l.req is not None)

    def start(self, req: Request) -> None:
        """Bind a request to a free lane -- lane ``req.instance`` when that
        one is free, so lanes usually read their own instance's weights in
        order and the chunk's matmuls stay one plain batched product."""
        order = list(range(self.lanes))
        if req.instance < self.lanes:
            order.remove(req.instance)
            order.insert(0, req.instance)
        for i in order:
            lane = self._lanes[i]
            if lane.req is None:
                lane.req = req
                lane.next_pos = 0
                lane.total = self.prefix + len(req.prompt) - 1
                lane.fresh = True
                self.admitted += 1
                return
        raise RuntimeError("no free prefill lane")

    def abort(self, request_id: int) -> bool:
        """Evict a request from its lane; the lane is free at once (a new
        request re-initialises its rows before its first chunk)."""
        for lane in self._lanes:
            if lane.req is not None and lane.req.request_id == request_id:
                lane.req = None
                return True
        return False

    def _zero_fresh(self) -> None:
        for i, lane in enumerate(self._lanes):
            if lane.req is not None and lane.fresh:
                for leaf in self._carry["cache"]:
                    leaf[:, i].zero_()
                lane.fresh = False

    # -- the chunk pump ------------------------------------------------------

    def advance(self, params, budget: int) -> list[tuple[Request, PrefillOut]]:
        """Run up to ``budget`` chunk calls; return the requests whose
        prefill completed.  Their rows alias the live carry, which the
        next ``advance`` updates in place: scatter them first."""
        self._zero_fresh()
        done: list[tuple[Request, PrefillOut]] = []
        for i, lane in enumerate(self._lanes):
            if lane.req is not None and lane.total == 0:
                # single-token prompt: the zeroed rows are its state
                done.append((lane.req, PrefillOut(None, i, 0, lane.req.prompt[-1])))
                lane.req = None
        stepped = False
        t0 = time.perf_counter()
        while budget > 0:
            workable = [i for i, l in enumerate(self._lanes)
                        if l.req is not None and l.total > l.next_pos]
            if not workable:
                break
            self._step(params, workable)
            stepped = True
            budget -= 1
            for i, lane in enumerate(self._lanes):
                if lane.req is not None and lane.next_pos >= lane.total:
                    done.append((lane.req, PrefillOut(None, i, lane.total,
                                                      lane.req.prompt[-1])))
                    lane.req = None
        if stepped:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if self.metrics is not None:
                self.metrics.note_prefill_wall(time.perf_counter() - t0)
        for _, out in done:
            out.cache = self._carry["cache"]
        return done

    def _step(self, params, workable: list[int]) -> None:
        k, c = self.lanes, self.chunk
        toks = np.zeros((k, 1, c), np.int32)
        # an idle lane computes nothing that is kept; its own index keeps
        # the lane -> instance map the identity where it can be
        inst = [i if i < self.cfg.num_instances else 0 for i in range(k)]
        offset = np.zeros((k, 1), np.int32)
        pvalid = np.zeros((k, 1, c), bool)
        tokens_done = 0
        staged: list[tuple[_Lane, int]] = []
        for i, lane in enumerate(self._lanes):
            if lane.req is None:
                continue
            inst[i] = lane.req.instance
            offset[i, 0] = lane.next_pos
            if i in workable:
                adv = min(c, lane.total - lane.next_pos)
                pvalid[i, 0, :adv] = True
                for j in range(adv):
                    p = lane.next_pos + j
                    if p >= self.prefix:
                        toks[i, 0, j] = lane.req.prompt[p - self.prefix]
                tokens_done += adv
                staged.append((lane, adv))
        dev = self.device
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "valid": torch.from_numpy(pvalid).to(dev)}
        api.prefill_chunk(self.cfg, params, batch, self._carry,
                          torch.from_numpy(offset).to(dev), instances=inst)
        self.device_calls += 1
        for lane, adv in staged:
            lane.next_pos += adv
        if self.metrics is not None:
            self.metrics.note_prefill_batch(len(workable), tokens_done)
