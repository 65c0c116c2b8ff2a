"""Multi-model serving engine — the paper's deployment scenario (port of
``repro.serving.engine``, dense, moe, ssm, hybrid, vlm and audio
families; tensor parallelism for dense, moe, hybrid and vlm; the data
axis for dense, moe, ssm and hybrid; audio on one device).

M fine-tuned instances of one architecture, merged on a leading
instances axis, are served from one program over a fixed (M, B) slot
grid:

* ``scheduler.py`` admits requests into free slots by policy,
* ``prefill.py`` streams prompts through the chunked prefill, its chunk
  calls interleaved with decode under a per-step budget,
* each engine step runs ONE K-step decode block over the whole grid:
  k decode+sample steps with tokens, positions, the alive mask and the
  remaining budgets kept on the device and stop computed with
  ``torch.where``; the (k, M, B) token and emitted blocks reach the host
  in one copy,
* the host unrolls the block token by token, so metrics, scheduler
  accounting and finish detection keep their per-token meaning.

A lane that stops mid-block freezes: its token, position and budget stop
advancing, and the decode step leaves its cache untouched (``alive``:
the dense decode layers and the hybrid blocks skip its ring append, the
ssm cells and the hybrid mamba branch keep its recurrent state), so K=1
and K>1 greedy streams are identical.  An
adaptive horizon shrinks k while prefill lanes are in flight or requests
wait.

Under tensor parallelism (``tp``, the reference's ``mesh=``/``rules=``)
every rank builds the same server on the same requests: it shards the
params and the caches at construction, the model sums the partials
across the ranks, and slot and lane surgery runs on the rank's shard.
Every host decision depends on the requests and the tokens only, never
on time or on anything one rank holds alone, so the ranks make the same
device calls in the same order and end with the same tokens.

The data axis of a (data=D, model=T) mesh changes which rows a rank
computes, never what any rank decides.  Every rank keeps the whole host
state (the scheduler over all M instances, the slot grid, the prefill
lanes, the metrics); a rank holds and computes only its data group's
block of the grid (``shardings.data_rows``: a block of instance rows, or
of slots, or all of it where D divides neither), through the local
config ``cfg.with_(num_instances=M_l)``.  Once per K-step block the
(k, M_l, B_l) token and emitted blocks are gathered over the data group,
so every rank unrolls the same (k, M, B) block and the ranks' streams are
identical.  They equal the single-device streams where a row's numbers do
not depend on how many instances a call holds (f32); in bf16 a call over
M_l instances may round otherwise than one over M (the decode matvec
splits its sum by M).  Only the rank that owns a slot scatters a finished
prefill into it.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.models import hybrid as H
from repro_torch.models.shardings import data_params, data_rows, shard_params
from repro_torch.serving.metrics import ServerMetrics
from repro_torch.serving.prefill import ChunkedPrefill
from repro_torch.serving.sampling import make_grid_sampler
from repro_torch.serving.scheduler import Request, Result, Scheduler, make_scheduler

SERVABLE_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


class MultiModelServer:
    """Continuous-batching decode over an (M, B) slot grid."""

    def __init__(
        self,
        cfg,
        params,                    # merged params (instances axis = M), whole
        *,
        slots_per_instance: int,
        max_context: int,
        eos_id: int | None = None,
        temperature: float = 0.0,
        top_k: int = 0,
        seed: int = 0,
        scheduler: str | Scheduler = "fifo",
        prefill_chunk: int = 32,
        prefill_lanes: int = 4,
        chunk_budget: int = 4,
        decode_steps: int = 1,
        device=None,
        tp=None,                   # a TensorParallel handle: this rank's place on the mesh
        first_instance: int = 0,   # the grid index of params' first instance
        sharded: bool = False,     # params are already this rank's model shard
    ):
        if cfg.family not in SERVABLE_FAMILIES:
            raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
        if cfg.family == "audio" and tp is not None:
            raise NotImplementedError("the audio family (whisper) serves on one device; "
                                      "a mesh is not ported for it")
        if cfg.family == "hybrid":
            need = H.min_serving_context(cfg)
            if max_context < need:
                raise ValueError(f"hybrid serving needs max_context >= meta+window = "
                                 f"{need}, got {max_context}")
        self.device = api.resolve_device(device)
        self.cfg = cfg
        self.m = cfg.num_instances
        self.b = slots_per_instance
        self.max_context = max_context
        self.eos_id = eos_id
        # the model gets the model group's handle where it has 2+ ranks;
        # the data group is the engine's alone
        data = None if tp is None else tp.data
        self.data = data if data is not None and data.size > 1 else None
        self.tp = tp if tp is not None and tp.size > 1 else None
        self.rows = data_rows(self.m, self.b, data)
        self.local_cfg = cfg.with_(num_instances=self.rows.m)
        shards = self.data.size if self.data is not None and self.rows.split == "instances" else 1
        self.scheduler = (make_scheduler(scheduler, self.m, shards)
                          if isinstance(scheduler, str) else scheduler)
        self.metrics = ServerMetrics(self.m, None if tp is None else {
            "data": 1 if data is None else data.size, "model": tp.size})
        self.prefill = ChunkedPrefill(self.local_cfg, max_context=max_context,
                                      device=self.device, chunk=prefill_chunk,
                                      lanes=prefill_lanes, metrics=self.metrics, tp=self.tp)
        self.chunk_budget = max(1, chunk_budget)
        # slice where the params lie, move the rank's block only
        params = data_params(params, self.rows, first_instance)
        if self.tp is not None and not sharded:
            params = shard_params(self.local_cfg, params, self.tp.rank, self.tp.size)
        self.params = params.to(self.device)
        self.cache = api.make_cache(self.local_cfg, self.rows.m, self.rows.b, max_context,
                                    self.device, tp=self.tp)
        self.pos = np.zeros((self.m, self.b), np.int32)
        self.cur_tok = np.zeros((self.m, self.b), np.int32)
        self.slot_busy = np.zeros((self.m, self.b), bool)
        # reserved for a request still prefilling: busy but not decoding
        self.slot_prefilling = np.zeros((self.m, self.b), bool)
        self._reserved: dict[int, tuple[int, int]] = {}
        self.active: list[list[Request | None]] = [[None] * self.b for _ in range(self.m)]
        self.generated: dict[int, list[int]] = {}
        self.steps = 0
        self._req_counter = 0
        self._greedy = temperature <= 0
        self._sample = make_grid_sampler(temperature, top_k)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.decode_steps = max(1, int(decode_steps))
        # ONE callable invoked exactly once per engine step (tests wrap it
        # to count decode dispatches)
        self._step = self._block

    # -- the K-step decode block ---------------------------------------------

    @torch.inference_mode()
    def _block(self, params, cache, tok, pos, alive, remaining, k: int):
        """k decode+sample steps over the rank's block of the grid with
        on-device stop.  Stop mirrors the host finish logic: budget
        exhausted, EOS, or position reaching ``max_context - 1``.  Returns
        (k, M, B) tokens and the (k, M, B) emitted mask (alive at entry of
        each step), as host arrays from one device-to-host copy, gathered
        over the data group."""
        cfg = self.local_cfg
        toks, emitted = [], []
        for _ in range(k):
            if self._greedy:
                picked, _ = api.decode_step_sample(cfg, params, cache, tok[..., None],
                                                   pos, alive=alive, tp=self.tp)
            else:
                logits, _ = api.decode_step(cfg, params, cache, tok[..., None], pos,
                                            alive=alive, tp=self.tp)
                picked = self._sample(logits, self._generator)
            nxt = torch.where(alive, picked, tok)
            new_pos = torch.where(alive, pos + 1, pos)
            new_rem = torch.where(alive, remaining - 1, remaining)
            stop = (new_rem <= 0) | (new_pos >= self.max_context - 1)
            if self.eos_id is not None:
                stop = stop | (nxt == self.eos_id)
            toks.append(nxt)
            emitted.append(alive)
            tok, pos, remaining, alive = nxt, new_pos, new_rem, alive & ~stop
        block = torch.stack([torch.stack(toks), torch.stack(emitted).to(torch.int32)])
        block = block.cpu()
        if self.data is not None and self.rows.split is not None:
            block = self.data.all_gather(block, 2 + self.rows.gather_dim)
        block = block.numpy()
        return block[0], block[1].astype(bool)

    # -- request admission ---------------------------------------------------

    def validate(self, req: Request) -> str | None:
        if not 0 <= req.instance < self.m:
            return f"instance {req.instance} out of range [0, {self.m})"
        if not req.prompt:
            return "empty prompt"
        if len(req.prompt) > self.prefill.max_prompt_len():
            return (f"prompt of {len(req.prompt)} tokens exceeds the serving "
                    f"context: at most {self.prefill.max_prompt_len()} prompt "
                    f"tokens fit max_context={self.max_context}")
        if req.max_new_tokens < 1:
            return f"max_new_tokens must be >= 1, got {req.max_new_tokens}"
        return None

    def try_submit(self, req: Request) -> int | Result:
        """Queue ``req`` and return its request_id, or a terminal
        ``Result(status="rejected")`` when validation fails."""
        req.request_id = self._req_counter
        self._req_counter += 1
        req.submit_time = time.perf_counter()
        err = self.validate(req)
        if err is not None:
            self.metrics.note_reject(req.instance)
            return Result(req.request_id, req.instance, [],
                          prompt_len=len(req.prompt) if req.prompt else 0,
                          status="rejected", error=err)
        self.scheduler.submit(req)
        self.metrics.note_submit(req.instance)
        return req.request_id

    def submit(self, req: Request) -> int:
        out = self.try_submit(req)
        if isinstance(out, Result):
            raise ValueError(out.error)
        return out

    def cancel(self, request_id: int, *, status: str = "cancelled") -> Result | None:
        """Abort a request wherever it is (queued, prefilling, decoding)
        and return its terminal Result with its partial tokens, or None
        if it is not live.  Host bookkeeping only: the freed slot is
        refilled from the queues on the next step."""
        req = self.scheduler.cancel(request_id)
        if req is not None:
            self.metrics.note_cancel(req.instance, queued=True, request_id=request_id)
            return Result(request_id, req.instance, [], prompt_len=len(req.prompt),
                          latency_s=time.perf_counter() - req.submit_time, status=status)
        if request_id in self._reserved:
            m, b = self._reserved.pop(request_id)
            req = self.active[m][b]
            self.prefill.abort(request_id)
            self._free(m, b)
            self.metrics.note_cancel(m, queued=False, request_id=request_id)
            return Result(request_id, m, [], prompt_len=len(req.prompt),
                          latency_s=time.perf_counter() - req.submit_time, status=status)
        for m in range(self.m):
            for b in range(self.b):
                req = self.active[m][b]
                if req is not None and req.request_id == request_id:
                    gen = self.generated.pop(request_id, [])
                    self._free(m, b)
                    self.metrics.note_cancel(m, queued=False, request_id=request_id)
                    return Result(request_id, m, gen, prompt_len=len(req.prompt),
                                  latency_s=time.perf_counter() - req.submit_time,
                                  status=status)
        return None

    def _free(self, m: int, b: int) -> None:
        self.slot_busy[m, b] = False
        self.slot_prefilling[m, b] = False
        self.active[m][b] = None

    def _admit(self):
        lanes = self.prefill.free_lanes()
        free = {i: int(self.b - self.slot_busy[i].sum()) for i in range(self.m)}
        if lanes == 0 or not any(free.values()) or self.scheduler.total_pending() == 0:
            return
        for req in self.scheduler.select(free, limit=lanes):
            m = req.instance
            b = next(bb for bb in range(self.b) if not self.slot_busy[m, bb])
            self.slot_busy[m, b] = True
            self.slot_prefilling[m, b] = True
            self._reserved[req.request_id] = (m, b)
            self.active[m][b] = req
            self.prefill.start(req, m - self.rows.m0 if self.rows.owns(m, b) else None)
            self.metrics.note_admit(m, len(req.prompt))

    def _finish_prefills(self, completed) -> None:
        """Scatter completed prefill lanes into their reserved slots (on
        the rank that holds the slot; every rank keeps the books)."""
        cfg, rows = self.local_cfg, self.rows
        for req, out in completed:
            m, b = self._reserved.pop(req.request_id)
            if rows.owns(m, b):
                with torch.inference_mode():
                    api.put_state(cfg, self.cache, api.take_state(cfg, out.cache, out.index, 0),
                                  m - rows.m0, b - rows.b0)
            self.metrics.note_scatter()
            self.pos[m, b] = out.pos
            self.cur_tok[m, b] = out.last_token
            self.slot_prefilling[m, b] = False
            self.generated[req.request_id] = []

    # -- engine step ----------------------------------------------------------

    def _decode_horizon(self) -> int:
        """Steps of the next block: full K in steady decode; 1 while
        prefill lanes are in flight; while requests wait, the largest
        power of two no decoding slot overshoots."""
        K = self.decode_steps
        if K <= 1:
            return K
        if self.prefill.in_flight():
            return 1
        if self.scheduler.total_pending() > 0:
            rem = [self.active[m][b].max_new_tokens
                   - len(self.generated[self.active[m][b].request_id])
                   for m in range(self.m) for b in range(self.b)
                   if self.slot_busy[m, b] and not self.slot_prefilling[m, b]]
            cap = min([K] + rem) if rem else 1
            k = 1
            while k * 2 <= cap:
                k *= 2
            return k
        return K

    def step(self) -> list[Result]:
        """Admit, advance prefill by at most ``chunk_budget`` chunk calls,
        run ONE k-step decode block over the grid, unroll it on the host,
        collect finished slots."""
        self._admit()
        if self.prefill.in_flight():
            t0 = time.perf_counter()
            with torch.inference_mode():
                completed = self.prefill.advance(self.params, self.chunk_budget)
            if (self.slot_busy & ~self.slot_prefilling).any():
                self.metrics.note_admission_stall(time.perf_counter() - t0)
            self._finish_prefills(completed)
        decoding = self.slot_busy & ~self.slot_prefilling
        if not decoding.any():
            return []
        k = self._decode_horizon()
        remaining = np.zeros((self.m, self.b), np.int32)
        for m in range(self.m):
            for b in range(self.b):
                if decoding[m, b]:
                    req = self.active[m][b]
                    remaining[m, b] = req.max_new_tokens - len(self.generated[req.request_id])
        dev = self.device
        put = lambda a: torch.from_numpy(np.ascontiguousarray(self.rows.block(a))).to(dev)
        t0 = time.perf_counter()
        toks, emitted = self._step(self.params, self.cache, put(self.cur_tok),
                                   put(self.pos), put(decoding), put(remaining), k)
        t_settled = time.perf_counter()
        self.steps += 1
        self.metrics.note_decode_call(steps=k, tokens=int(emitted.sum()),
                                      wall_s=t_settled - t0)
        done: list[Result] = []
        for j in range(k):
            for m in range(self.m):
                for b in range(self.b):
                    if not (decoding[m, b] and self.slot_busy[m, b]):
                        continue
                    req = self.active[m][b]
                    t = int(toks[j, m, b])
                    gen = self.generated[req.request_id]
                    self.metrics.note_token(m, first=not gen, submit_time=req.submit_time,
                                            request_id=req.request_id)
                    self.scheduler.note_generated(m, 1)
                    gen.append(t)
                    self.pos[m, b] += 1
                    self.cur_tok[m, b] = t
                    hit_eos = self.eos_id is not None and t == self.eos_id
                    finished = (len(gen) >= req.max_new_tokens or hit_eos
                                or int(self.pos[m, b]) >= self.max_context - 1)
                    if finished:
                        done.append(Result(
                            req.request_id, m, gen, prompt_len=len(req.prompt),
                            latency_s=time.perf_counter() - req.submit_time,
                            finish_reason="stop" if hit_eos else "length"))
                        self.metrics.note_complete(m, req.submit_time,
                                                   request_id=req.request_id)
                        self._free(m, b)
                        del self.generated[req.request_id]
        return done

    def busy(self) -> bool:
        return bool(self.slot_busy.any() or self.prefill.in_flight() > 0
                    or self.scheduler.total_pending() > 0)

    def run_until_drained(self, max_steps: int = 10_000) -> list[Result]:
        out: list[Result] = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.busy():
                return out
        raise RuntimeError("serving did not drain")
