"""Chunked prefill for serving admission (port of
``repro.serving.prefill``, every served family; under tensor parallelism
``tp`` makes the carry a rank's shard; on a mesh with a data axis
``cfg`` is the rank's local config).

Every prompt streams through ``api.prefill_chunk`` in fixed-size chunks;
the final partial chunk is padded and masked per position (tail
folding), so a lane batch drains in ``ceil(L_max / chunk)`` chunk calls.
Up to ``lanes`` requests prefill together in ONE carry, each lane reading
its own fine-tune's weights through views (``instances=``), at its own
offset.  The engine grants a per-step chunk budget, so prefill work
interleaves with decode.  ``tail_fold=False`` keeps the reference's
A/B option: lanes with less than a chunk left advance one position per
call instead (single-token tail calls, chunk and tail rounds
alternating).

The reference re-initialises ``fresh`` lanes and keeps non-working
lanes unchanged by selecting between carry trees.  The port's carry is
updated in place: a fresh lane's rows are copied from a one-lane initial
carry before the call (``tree_reset_lanes``, the in-place form of the
reference's ``tree_select_lanes(fresh, init, carry)``: zeros for a KV
cache, zeros and m = -1e30 for a recurrent state).  A lane's junk suffix
and a lane that does not advance get False in the per-position ``valid``
mask: a KV cache drops those rows, a recurrent cell takes neutral gates
there.  Every lane that holds a request advances in every call; a lane
whose prefill completed earlier in the same ``advance`` rides the later
calls as junk and keeps its state exactly (after its first real step its
stabilizer m is finite, so the neutral gates give forget 1 and input 0)
until the engine scatters it.  The chunk is clamped to the narrowest
ring of the cache (dense sliding window, hybrid SWA ring after the meta
tokens); recurrent state has no ring.  Hybrid prompts start after the
``prefill_prefix_len`` meta positions, whose chunk rows the model fills
from its meta-token embeddings; vlm prompts start after the P image-patch
positions, and every vlm chunk call carries zero patch embeddings
(lanes, 1, P, vision_dim), as the reference serves them (the vision
encoder is a stub).  Every audio chunk call carries zero frame
embeddings (lanes, 1, F, d_model), which the model's encoder reruns on
(its prompts start at position 0).  A moe chunk call also carries each
lane's ``moe_limit``, the capacity an exact-length pass over the lane's
real tokens would use (0 on a lane with no request), and a fresh lane's
per-expert counts start at zero with its carry rows.

With a tracer or an accounting ledger on, each chunk call is settled
(``api.settle``) and recorded; with both off no call is settled but the
last of an ``advance``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import api
from repro_torch.models import hybrid as H
from repro_torch.models import moe
from repro_torch.models.common import tree_reset_lanes
from repro_torch.serving.scheduler import Request

DEFAULT_CHUNK = 32
DEFAULT_LANES = 4


@dataclasses.dataclass
class PrefillOut:
    """One admitted request's prefill product: row ``index`` of the
    shared carry's cache (of the pristine one-lane carry for a
    single-token prompt).  The engine scatters it into the request's grid
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
    row: int | None = None     # local instance row; None: the request lives elsewhere


class ChunkedPrefill:
    def __init__(self, cfg, *, max_context: int, device, chunk: int = DEFAULT_CHUNK,
                 lanes: int = DEFAULT_LANES, metrics=None, tp=None,
                 tail_fold: bool = True, tracer=None, accounting=None):
        api.family_module(cfg)                # raises for a family not ported
        self.cfg = cfg
        self.tp = tp
        self.device = torch.device(device)
        self.max_context = max_context
        self.metrics = metrics
        # engine-owned observers (None for standalone use); every site
        # guards on ``.enabled``, so with both off nothing is settled
        self.tracer = tracer
        self.accounting = accounting
        self.tail_fold = tail_fold
        self._tail_turn = False             # chunk / tail round alternation
        self._widths: set[int] = set()      # chunk widths ever called
        self.lanes = max(1, lanes)
        # a chunk must map to distinct cache slots: clamp it to the ring
        ring = self._min_ring_width()
        self.chunk = max(1, min(chunk, ring if ring else chunk))
        self.prefix = api.prefill_prefix_len(cfg)
        if self.max_prompt_len() <= 0:
            raise ValueError(f"max_context={max_context} leaves no room for a prompt")
        self._carry = api.init_chunk_carry(cfg, self.lanes, 1, max_context, self.device, tp=tp)
        self._carry_axes = api.chunk_carry_axes(cfg)
        # one lane of initial carry: the rows a fresh lane starts from
        self._init_lane = api.init_chunk_carry(cfg, 1, 1, max_context, self.device, tp=tp)
        self._lanes = [_Lane() for _ in range(self.lanes)]
        self.device_calls = 0               # chunk calls
        self.admitted = 0                   # lanes ever started

    def _min_ring_width(self) -> int:
        """Narrowest ring of the family's caches (0: none): the sliding
        window (dense, moe, vlm), the SWA ring after the pinned meta tokens
        (hybrid; ``make_cache`` clips it to ``max_context``)."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            s_cache = min(H.NUM_META_TOKENS + H.swa_window(cfg), self.max_context)
            return max(s_cache - H.NUM_META_TOKENS, 1)
        return cfg.sliding_window if cfg.family in ("dense", "moe", "vlm") else 0

    def max_prompt_len(self) -> int:
        return self.max_context - self.prefix

    @property
    def compiled_shapes(self) -> int:
        """Distinct chunk widths called: 1 with tail folding, at most 2
        (the chunk and the single-token tail) without."""
        return len(self._widths)

    # -- lane bookkeeping ----------------------------------------------------

    def free_lanes(self) -> int:
        return sum(1 for l in self._lanes if l.req is None)

    def in_flight(self) -> int:
        return sum(1 for l in self._lanes if l.req is not None)

    def start(self, req: Request, row: int | None) -> None:
        """Bind a request to a free lane -- lane ``req.instance`` when that
        one is free, so lanes usually read their own instance's weights in
        order and the chunk's matmuls stay one plain batched product.
        ``row`` is the local instance row the lane reads (on one device
        the instance itself), None where the request lives on another
        data group."""
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
                lane.row = row
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

    def reset(self) -> None:
        """Crash recovery: evict every lane.  The next request on a lane
        starts from the initial carry rows (``fresh``), so a carry a
        failed call left half written is never read."""
        for lane in self._lanes:
            lane.req = None
            lane.fresh = False
        self._tail_turn = False

    def _reset_fresh(self) -> None:
        fresh = [i for i, lane in enumerate(self._lanes)
                 if lane.req is not None and lane.fresh]
        tree_reset_lanes(self._carry, self._init_lane, self._carry_axes, fresh)
        for i in fresh:
            self._lanes[i].fresh = False

    # -- the chunk pump ------------------------------------------------------

    def advance(self, params, budget: int,
                step: int = 0) -> list[tuple[Request, PrefillOut]]:
        """Run up to ``budget`` chunk calls; return the requests whose
        prefill completed.  Their rows alias the live carry, which the
        next ``advance`` updates in place: scatter them first.  ``step``
        tags trace events with the engine's step counter."""
        # a single-token prompt needs no chunk call: its state is the
        # initial one, taken from the pristine one-lane carry (the live
        # lane turns idle, and idle lanes ride later calls as junk)
        zero_done: list[tuple[Request, PrefillOut]] = []
        for lane in self._lanes:
            if lane.req is not None and lane.total == 0:
                zero_done.append((lane.req, PrefillOut(self._init_lane["cache"], 0, 0,
                                                       lane.req.prompt[-1])))
                lane.req = None
        self._reset_fresh()
        done: list[tuple[Request, PrefillOut]] = []
        stepped = False
        t0 = time.perf_counter()
        while budget > 0:
            left = {i: l.total - l.next_pos for i, l in enumerate(self._lanes)
                    if l.req is not None and l.total > l.next_pos}
            if not left:
                break
            if self.tail_fold:
                # every lane with work advances; a lane with less than a
                # chunk left rides a padded final chunk, masked per position
                workable, c = list(left), self.chunk
            else:
                chunkable = [i for i, n in left.items() if n >= self.chunk]
                tailable = [i for i, n in left.items() if n < self.chunk]
                # alternate when both kinds of work exist, so a lane one
                # token from done is not starved behind full chunks
                run_tail = bool(tailable) and (self._tail_turn or not chunkable)
                self._tail_turn = not run_tail
                workable, c = (tailable, 1) if run_tail else (chunkable, self.chunk)
            self._step(params, workable, c, step)
            stepped = True
            budget -= 1
            for i, lane in enumerate(self._lanes):
                if lane.req is not None and lane.next_pos >= lane.total:
                    done.append((lane.req, PrefillOut(None, i, lane.total,
                                                      lane.req.prompt[-1])))
                    lane.req = None
        if stepped:
            api.settle(self.device)
            if self.metrics is not None:
                self.metrics.note_prefill_wall(time.perf_counter() - t0)
        for _, out in done:
            out.cache = self._carry["cache"]
        return zero_done + done

    def _step(self, params, workable: list[int], c: int, step: int) -> None:
        k = self.lanes
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
            inst[i] = 0 if lane.row is None else lane.row
            offset[i, 0] = lane.next_pos
            if i in workable:
                adv = min(c, lane.total - lane.next_pos)
                tokens_done += adv
                staged.append((lane, adv))
                if lane.row is None:
                    continue
                pvalid[i, 0, :adv] = True
                for j in range(adv):
                    p = lane.next_pos + j
                    if p >= self.prefix:
                        toks[i, 0, j] = lane.req.prompt[p - self.prefix]
        dev = self.device
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "valid": torch.from_numpy(pvalid).to(dev)}
        if self.cfg.family == "moe":
            limit = np.zeros((k, 1), np.int32)
            for i, lane in enumerate(self._lanes):
                if lane.req is not None and lane.total > 0:
                    limit[i, 0] = moe.capacity(self.cfg, lane.total)
            batch["moe_limit"] = torch.from_numpy(limit).to(dev)
        if self.cfg.family == "vlm":
            batch["image_embeds"] = torch.zeros(
                (k, 1, self.cfg.num_image_patches, self.cfg.vision_embed_dim),
                dtype=getattr(torch, self.cfg.dtype), device=dev)
        if self.cfg.family == "audio":
            batch["frames"] = torch.zeros(
                (k, 1, self.cfg.num_audio_frames, self.cfg.d_model),
                dtype=getattr(torch, self.cfg.dtype), device=dev)
        tr, acct = self.tracer, self.accounting
        trace_on = tr is not None and tr.enabled
        acct_on = acct is not None and acct.enabled
        if trace_on or acct_on:
            t0 = time.perf_counter()
        api.prefill_chunk(self.cfg, params, batch, self._carry,
                          torch.from_numpy(offset).to(dev), instances=inst, tp=self.tp)
        self.device_calls += 1
        self._widths.add(c)
        for lane, adv in staged:
            lane.next_pos += adv
        if trace_on or acct_on:
            t_dispatch = time.perf_counter()
            # a settle per chunk is the cost of observing: it buys the
            # call's device time; the unobserved path settles once per
            # advance
            api.settle(dev)
            t_settled = time.perf_counter()
            if trace_on:
                tr.device_call(
                    "prefill_chunk", t0, t_dispatch, t_settled, step=step,
                    lanes_busy=self.in_flight(), lanes=self.lanes,
                    valid_frac=tokens_done / (len(workable) * c),
                    tokens=tokens_done)
            if acct_on:
                # each busy lane charges its tenant wall / lanes; the
                # unoccupied lanes are idle
                acct.note_prefill(t_settled - t0,
                                  [self._lanes[i].req.instance for i in workable],
                                  self.lanes)
        if self.metrics is not None:
            self.metrics.note_prefill_batch(len(workable), tokens_done)
