"""Multi-model serving engine — the paper's deployment scenario (port of
``repro.serving.engine``, dense, moe, ssm, hybrid, vlm and audio
families; tensor parallelism for dense, moe, ssm, hybrid and vlm; the
data axis for all six).

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

Around the decode block sits the reference's serving periphery, all of it
host-side: a step tracer and a per-tenant ledger (``obs/``), a fault
injector, per-instance health and an overload brownout policy
(``resilience/``), and the ``on_token`` hook the async frontend streams
from.  Each is always attached and off until started or armed; every
call site guards on ``.enabled`` / ``.armed``, so the path with all of
them off runs none of their code and settles nothing it did not settle
before.  The decode block returns, beside the tokens, a (k, M, B)
finite-logits mask in the same device-to-host copy (the NaN/Inf guard):
a row whose logits went non-finite fails its request and quarantines its
instance, and the other rows stream on.  A crash leaves the host state
consistent (every fault site fires before its device call), so
``reset_serving_state`` + ``requeue`` replay every live request; a
failed chunk or scatter call fails the requests it held, or, under a
``Supervisor`` (``supervised``), propagates as a crash the supervisor
recovers by the same replay (those requests have emitted nothing yet); a
greedy stream depends on its own prompt alone, so the replayed prefix is
regenerated bit for bit and its re-emission suppressed (``emit_skip``).
The periphery serves on one device: on a mesh the armed fault sites
raise, and so do ``AsyncEngine`` and ``Supervisor``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.models import hybrid as H
from repro_torch.models.shardings import data_params, data_rows, refuse_family, shard_params
from repro_torch.serving.metrics import ServerMetrics
from repro_torch.serving.obs.accounting import TenantAccounting
from repro_torch.serving.obs.flight import FlightRecorder
from repro_torch.serving.obs.trace import Tracer
from repro_torch.serving.prefill import ChunkedPrefill
from repro_torch.serving.resilience.faults import MESH_PERIPHERY, FaultInjector
from repro_torch.serving.resilience.health import HealthMonitor
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
        tail_fold: bool = True,
        decode_steps: int = 1,
        device=None,
        tp=None,                   # a TensorParallel handle: this rank's place on the mesh
        first_instance: int = 0,   # the grid index of params' first instance
        sharded: bool = False,     # params are already this rank's model shard
        tracer: Tracer | None = None,
        faults: FaultInjector | None = None,
        health: HealthMonitor | None = None,
        policy=None,
        accounting: TenantAccounting | None = None,
        flight: FlightRecorder | None = None,
        slo=None,
    ):
        if cfg.family not in SERVABLE_FAMILIES:
            raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
        if tp is not None and tp.size > 1:
            refuse_family(cfg)           # audio has a data axis, no model axis
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
        # the handle as given: any mesh, however small, keeps the
        # periphery off (MESH_PERIPHERY)
        self.mesh = tp
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
        # SLO objectives ride the metrics: evaluated at snapshot time only
        self.slo = slo
        self.metrics = self._new_metrics(slo)
        # always attached, off by default: every site guards on .enabled
        self.tracer = tracer if tracer is not None else Tracer()
        self.accounting = accounting if accounting is not None else TenantAccounting(self.m)
        self.accounting.m = self.m
        self.flight = flight if flight is not None else FlightRecorder()
        # disarmed by default: every site guards on .armed
        self.faults = faults if faults is not None else FaultInjector()
        self.health = health if health is not None else HealthMonitor(self.m)
        self.policy = policy                 # None: no shedding, no capping
        # set by a Supervisor: a failed chunk or scatter call then propagates
        # as a crash, and the supervisor replays every live request; alone,
        # the engine fails the requests the call held
        self.supervised = False
        # terminal Results made while an exception propagated, delivered
        # by the next step
        self._pending_failures: list[Result] = []
        self.prefill = ChunkedPrefill(self.local_cfg, max_context=max_context,
                                      device=self.device, chunk=prefill_chunk,
                                      lanes=prefill_lanes, metrics=self.metrics, tp=self.tp,
                                      tail_fold=tail_fold, tracer=self.tracer,
                                      accounting=self.accounting)
        self._wire_metrics()
        self.accounting.queued_fn = self.scheduler.queued_instances
        if self.flight.enabled:
            self.health.on_quarantine = lambda i: self.flight.dump(
                f"quarantine: instance {i}", server=self)
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
        # on_token(request_id, token, finished) for every emitted token,
        # called during the host unroll (the async frontend streams from it)
        self.on_token = None
        self._seed = seed
        self._greedy = temperature <= 0
        self._sample = make_grid_sampler(temperature, top_k)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.decode_steps = max(1, int(decode_steps))
        # ONE callable invoked exactly once per engine step (tests wrap it
        # to count decode dispatches)
        self._step = self._block

    def _new_metrics(self, slo) -> ServerMetrics:
        return ServerMetrics(self.m, None if self.mesh is None else {
            "data": 1 if self.mesh.data is None else self.mesh.data.size,
            "model": self.mesh.size}, slo=slo)

    def _wire_metrics(self) -> None:
        self.metrics.compiled_shapes_fn = lambda: self.prefill.compiled_shapes
        self.metrics.health_fn = self.health.snapshot
        self.metrics.accounting_fn = self.accounting.snapshot
        self.prefill.metrics = self.metrics

    def _fault(self, site: str) -> set[int]:
        """The armed injector's call at ``site`` (the caller guards on
        ``faults.armed``)."""
        if self.mesh is not None:
            raise NotImplementedError(MESH_PERIPHERY)
        return self.faults.on_call(site)

    # -- the K-step decode block ---------------------------------------------

    @torch.inference_mode()
    def _block(self, params, cache, tok, pos, alive, remaining, k: int):
        """k decode+sample steps over the rank's block of the grid with
        on-device stop.  Stop mirrors the host finish logic: budget
        exhausted, EOS, or position reaching ``max_context - 1``.  Returns
        (k, M, B) tokens, the (k, M, B) emitted mask (alive at entry of
        each step) and the (k, M, B) finite-logits mask (the NaN/Inf
        guard: the sampler's, or all True on the fused greedy path, which
        never holds the logits), as host arrays from one device-to-host
        copy, gathered over the data group."""
        cfg = self.local_cfg
        toks, emitted, oks = [], [], []
        for _ in range(k):
            if self._greedy:
                picked, _ = api.decode_step_sample(cfg, params, cache, tok[..., None],
                                                   pos, alive=alive, tp=self.tp)
            else:
                logits, _ = api.decode_step(cfg, params, cache, tok[..., None], pos,
                                            alive=alive, tp=self.tp)
                picked, ok = self._sample(logits, self._generator)
                oks.append(ok.reshape(alive.shape))
            nxt = torch.where(alive, picked, tok)
            new_pos = torch.where(alive, pos + 1, pos)
            new_rem = torch.where(alive, remaining - 1, remaining)
            stop = (new_rem <= 0) | (new_pos >= self.max_context - 1)
            if self.eos_id is not None:
                stop = stop | (nxt == self.eos_id)
            toks.append(nxt)
            emitted.append(alive)
            tok, pos, remaining, alive = nxt, new_pos, new_rem, alive & ~stop
        rows = [torch.stack(toks), torch.stack(emitted).to(torch.int32)]
        if oks:
            rows.append(torch.stack(oks).to(torch.int32))
        block = torch.stack(rows)
        self._dispatched = time.perf_counter()    # every launch issued
        block = block.cpu()
        if self.data is not None and self.rows.split is not None:
            block = self.data.all_gather(block, 2 + self.rows.gather_dim)
        block = block.numpy()
        ok = block[2].astype(bool) if oks else np.ones(block[0].shape, bool)
        return block[0], block[1].astype(bool), ok

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

    def try_submit(self, req: Request, *, submit_time: float | None = None) -> int | Result:
        """Queue ``req`` and return its request_id, or a terminal Result:
        ``rejected`` when validation fails, ``unavailable`` when its
        instance is quarantined.  ``submit_time`` is the client's clock
        where a frontend queued the request ahead of the engine."""
        req.request_id = self._req_counter
        self._req_counter += 1
        req.submit_time = submit_time if submit_time is not None else time.perf_counter()
        err = self.validate(req)
        if err is not None:
            self.metrics.note_reject(req.instance)
            return Result(req.request_id, req.instance, [],
                          prompt_len=len(req.prompt) if req.prompt else 0,
                          status="rejected", error=err)
        # a quarantined row turns away its own tenant only
        if not self.health.admissible(req.instance):
            self.metrics.note_reject(req.instance)
            return Result(req.request_id, req.instance, [], prompt_len=len(req.prompt),
                          status="unavailable",
                          error=f"instance {req.instance} is quarantined "
                                f"({self.health.state(req.instance)}); retry later")
        if self.policy is not None:
            self.policy.cap_request(req)     # brownout: shorter answers
        self.scheduler.submit(req)
        self.metrics.note_submit(req.instance)
        if self.tracer.enabled:
            self.tracer.request_event(req.request_id, "submit", instance=req.instance)
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
            m, gen = req.instance, []
            self.metrics.note_cancel(m, queued=True, request_id=request_id)
        elif request_id in self._reserved:
            m, b = self._reserved.pop(request_id)
            req, gen = self.active[m][b], []
            self.prefill.abort(request_id)
            self._free(m, b)
            self.metrics.note_cancel(m, queued=False, request_id=request_id)
        else:
            found = [(m, b) for m in range(self.m) for b in range(self.b)
                     if self.active[m][b] is not None
                     and self.active[m][b].request_id == request_id]
            if not found:
                return None
            m, b = found[0]
            req = self.active[m][b]
            gen = self.generated.pop(request_id, [])
            self._free(m, b)
            self.metrics.note_cancel(m, queued=False, request_id=request_id)
        if self.tracer.enabled:
            self.tracer.request_event(request_id, "cancel", instance=m, status=status)
        return Result(request_id, m, gen, prompt_len=len(req.prompt),
                      latency_s=time.perf_counter() - req.submit_time, status=status)

    def _free(self, m: int, b: int) -> None:
        self.slot_busy[m, b] = False
        self.slot_prefilling[m, b] = False
        self.active[m][b] = None

    def _admit(self):
        lanes = self.prefill.free_lanes()
        # a quarantined row offers no free slot: its queue waits it out
        free = {i: (int(self.b - self.slot_busy[i].sum()) if self.health.admissible(i) else 0)
                for i in range(self.m)}
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
            if self.accounting.enabled and req.submit_time > 0:
                wait = time.perf_counter() - req.submit_time
                if wait >= 0:
                    self.accounting.note_queue_wait(m, wait)
            if self.tracer.enabled:
                self.tracer.request_event(req.request_id, "admit", instance=m)

    # -- failures -----------------------------------------------------------

    def _fail_slot(self, req: Request, m: int, b: int, exc, *,
                   poisoned: bool = False) -> Result:
        """Fail an admitted request terminally and free its slot and lane:
        a failed device call frees the slot or fails the request, never
        leaks either."""
        rid = req.request_id
        self._reserved.pop(rid, None)
        if self.slot_prefilling[m, b]:
            self.prefill.abort(rid)
        self._free(m, b)
        gen = self.generated.pop(rid, [])
        before = self.health.state(m)
        if poisoned:
            self.health.note_poisoned(m)
        else:
            self.health.note_failure(m)
        self.metrics.note_failed(m, request_id=rid)
        if self.tracer.enabled:
            self.tracer.request_event(rid, "finish", instance=m, status="error")
            if before != "quarantined" and self.health.state(m) == "quarantined":
                self.tracer.request_event(rid, "quarantine", instance=m,
                                          status="poisoned" if poisoned else "failures")
        return Result(rid, m, gen, prompt_len=len(req.prompt),
                      latency_s=time.perf_counter() - req.submit_time,
                      status="error", error=f"{type(exc).__name__}: {exc}")

    def _fail_prefilling(self, exc) -> list[Result]:
        """A chunk call failed.  Its lanes shared the call, so every
        request mid-prefill fails and the lanes are evicted."""
        rids = sorted(rid for rid, (m, b) in self._reserved.items()
                      if self.slot_prefilling[m, b])
        failures = []
        for rid in rids:
            m, b = self._reserved[rid]
            failures.append(self._fail_slot(self.active[m][b], m, b, exc))
        self.prefill.reset()
        return failures

    def _finish_prefills(self, completed) -> list[Result]:
        """Scatter completed prefill lanes into their reserved slots (on
        the rank that holds the slot; every rank keeps the books).
        Returns the terminal Results of requests whose scatter failed
        (their slots are freed, not leaked: the scatter writes the whole
        slot in place, and the next request on it writes it again)."""
        cfg, rows, tr, acct = self.local_cfg, self.rows, self.tracer, self.accounting
        failures: list[Result] = []
        for req, out in completed:
            m, b = self._reserved[req.request_id]
            trace_on = tr.enabled
            obs_on = trace_on or acct.enabled
            if obs_on:
                t0 = time.perf_counter()
            try:
                if self.faults.armed:
                    self._fault("scatter")
                if rows.owns(m, b):
                    with torch.inference_mode():
                        api.put_state(cfg, self.cache,
                                      api.take_state(cfg, out.cache, out.index, 0),
                                      m - rows.m0, b - rows.b0)
            except Exception as exc:
                if self.supervised or isinstance(exc, NotImplementedError):
                    raise
                failures.append(self._fail_slot(req, m, b, exc))
                continue
            self._reserved.pop(req.request_id)
            self.metrics.note_scatter()
            if obs_on:
                t1 = time.perf_counter()
                # settle so the recorded time is the device's, not the
                # dispatch's (the decode that follows reads this slot anyway)
                api.settle(self.device)
                t_settled = time.perf_counter()
                if trace_on:
                    tr.device_call("scatter", t0, t1, t_settled, step=self.steps,
                                   capacity=self.m * self.b,
                                   active=int((self.slot_busy & ~self.slot_prefilling).sum()))
                    tr.request_event(req.request_id, "prefill_done", instance=m)
                if acct.enabled:
                    acct.note_scatter(t_settled - t0, m)   # one request: one tenant
            self.pos[m, b] = out.pos
            self.cur_tok[m, b] = out.last_token
            self.slot_prefilling[m, b] = False
            self.generated[req.request_id] = []
        return failures

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
        out: list[Result] = self._pending_failures
        self._pending_failures = []
        if self.policy is not None:
            out.extend(self._apply_policy())
        self._admit()
        if self.prefill.in_flight():
            t0 = time.perf_counter()
            try:
                if self.faults.armed:
                    self._fault("prefill")
                with torch.inference_mode():
                    completed = self.prefill.advance(self.params, self.chunk_budget,
                                                     step=self.steps)
            except Exception as exc:
                if self.supervised or isinstance(exc, NotImplementedError):
                    raise
                out.extend(self._fail_prefilling(exc))
                completed = []
            if (self.slot_busy & ~self.slot_prefilling).any():
                self.metrics.note_admission_stall(time.perf_counter() - t0)
            out.extend(self._finish_prefills(completed))
        decoding = self.slot_busy & ~self.slot_prefilling
        if not decoding.any():
            self.health.note_step()
            return out
        k = self._decode_horizon()
        remaining = np.zeros((self.m, self.b), np.int32)
        for m in range(self.m):
            for b in range(self.b):
                if decoding[m, b]:
                    req = self.active[m][b]
                    remaining[m, b] = req.max_new_tokens - len(self.generated[req.request_id])
        dev = self.device
        put = lambda a: torch.from_numpy(np.ascontiguousarray(self.rows.block(a))).to(dev)
        # the fault fires BEFORE the dispatch, while the host state is
        # still whole, so a reset + requeue replays cleanly
        poison = self._fault("decode") if self.faults.armed else ()
        tr = self.tracer
        trace_on = tr.enabled
        t0 = self._dispatched = time.perf_counter()
        toks, emitted, oks = self._step(self.params, self.cache, put(self.cur_tok),
                                        put(self.pos), put(decoding), put(remaining), k)
        t_settled = time.perf_counter()
        t_dispatch = self._dispatched
        self.steps += 1
        for i in poison:
            # an injected NaN flips the guard for row i exactly as
            # non-finite logits would
            oks[:, i, :] = False
        block_tokens = int(emitted.sum())
        # dispatch: until the block's last launch was issued; settled:
        # its tokens on the host
        self.metrics.note_decode_call(steps=k, tokens=block_tokens,
                                      wall_s=t_settled - t0, dispatch_s=t_dispatch - t0)
        if trace_on:
            tr.device_call("decode", t0, t_dispatch, t_settled, step=self.steps,
                           active=int(decoding.sum()), capacity=self.m * self.b,
                           lanes_busy=self.prefill.in_flight(), lanes=self.prefill.lanes,
                           tokens=block_tokens, pending=self.scheduler.total_pending(),
                           decode_steps=k)
        acct = self.accounting
        acct_on = acct.enabled
        if acct_on:
            # the call's settled wall, split slot-weighted over the tenants
            # on the grid; empty slots bill to idle
            acct.note_decode(t_settled - t0, [int(c) for c in decoding.sum(axis=1)],
                             self.m * self.b)
            replay_counts: dict[int, int] = {}
        done: list[Result] = []
        for j in range(k):
            for m in range(self.m):
                for b in range(self.b):
                    if not (decoding[m, b] and self.slot_busy[m, b]):
                        continue
                    req = self.active[m][b]
                    if not oks[j, m, b]:
                        # the NaN/Inf guard: fail the request, quarantine
                        # the instance; the other rows stream on
                        done.append(self._fail_slot(
                            req, m, b, RuntimeError("non-finite logits (NaN/Inf token guard)"),
                            poisoned=True))
                        continue
                    t = int(toks[j, m, b])
                    gen = self.generated[req.request_id]
                    # recovery replay: the first ``emit_skip`` tokens reached
                    # the client before a crash; greedy decode regenerates
                    # them, and they are not emitted again
                    replay = len(gen) < req.emit_skip
                    if replay:
                        exp = req.replay_expect
                        if exp is not None and exp[len(gen)] != t:
                            self.metrics.replay_mismatches += 1
                        self.metrics.note_replay(m)
                        if acct_on:
                            replay_counts[m] = replay_counts.get(m, 0) + 1
                    else:
                        self.metrics.note_token(m, first=not gen and not req.emit_skip,
                                                submit_time=req.submit_time,
                                                request_id=req.request_id)
                    self.scheduler.note_generated(m, 1)
                    gen.append(t)
                    self.pos[m, b] += 1
                    self.cur_tok[m, b] = t
                    hit_eos = self.eos_id is not None and t == self.eos_id
                    finished = (len(gen) >= req.max_new_tokens or hit_eos
                                or int(self.pos[m, b]) >= self.max_context - 1)
                    if self.on_token is not None and not replay:
                        self.on_token(req.request_id, t, finished)
                    if finished:
                        done.append(Result(
                            req.request_id, m, gen, prompt_len=len(req.prompt),
                            latency_s=time.perf_counter() - req.submit_time,
                            finish_reason="stop" if hit_eos else "length"))
                        self.metrics.note_complete(m, req.submit_time,
                                                   request_id=req.request_id)
                        self.health.note_success(m)
                        if trace_on:
                            tr.request_event(req.request_id, "finish", instance=m,
                                             status="ok")
                        self._free(m, b)
                        del self.generated[req.request_id]
        if acct_on and replay_counts:
            # the token-weighted share of this call spent regenerating
            # tokens the clients already had
            acct.note_replay(replay_counts, t_settled - t0, block_tokens)
        self.health.note_step()
        out.extend(done)
        return out

    # -- overload brownout ----------------------------------------------------

    def _apply_policy(self) -> list[Result]:
        """One step's brownout bookkeeping: feed the queue depth to the
        degraded-mode hysteresis and shed queued requests older than the
        policy's cutoff."""
        pol = self.policy
        pol.note_depth(self.scheduler.total_pending())
        if pol.shed_age_s is None:
            return []
        now = time.perf_counter()
        out = []
        for req in self.scheduler.shed_older_than(now - pol.shed_age_s):
            pol.shed_total += 1
            self.metrics.note_shed(req.instance)
            if self.tracer.enabled:
                self.tracer.request_event(req.request_id, "shed", instance=req.instance)
            out.append(Result(req.request_id, req.instance, [], prompt_len=len(req.prompt),
                              latency_s=now - req.submit_time, status="shed",
                              error=f"queued longer than {pol.shed_age_s}s under "
                                    f"overload; retry later"))
        return out

    # -- crash recovery -------------------------------------------------------

    def reset_serving_state(self) -> list[tuple[Request, list[int]]]:
        """Tear the serving state back to empty after a crash: every slot
        and lane free, the grid cache restored to its initial values, the
        sampling generator reseeded; the request-id counter and the
        cumulative metrics stay.  Returns every live request (queued,
        prefilling or decoding) with its generated prefix, by request_id.

        The cache is restored IN PLACE: one slot of initial cache (zeros
        for a KV cache; the recurrent states' own initial values, not all
        zeros) is built and written into every slot through the slot
        surgery, so no second grid cache is ever allocated beside the
        live one."""
        live: list[tuple[Request, list[int]]] = []
        for m in range(self.m):
            for b in range(self.b):
                req = self.active[m][b]
                if req is not None:
                    live.append((req, list(self.generated.get(req.request_id, []))))
                self.active[m][b] = None
        live.extend((req, []) for req in self.scheduler.drain_all())
        live.sort(key=lambda t: t[0].request_id)
        self._reserved.clear()
        self.generated.clear()
        self._pending_failures = []
        self.pos[:] = 0
        self.cur_tok[:] = 0
        self.slot_busy[:] = False
        self.slot_prefilling[:] = False
        self.prefill.reset()
        self.metrics.reset_queue_depths()
        cfg = self.local_cfg
        with torch.inference_mode():
            one = api.make_cache(cfg, 1, 1, self.max_context, self.device, tp=self.tp)
            for m in range(self.rows.m):
                for b in range(self.rows.b):
                    api.put_state(cfg, self.cache, one, m, b)
        self._generator.manual_seed(self._seed)
        return live

    def requeue(self, req: Request, *, emitted: list[int] | None = None) -> int:
        """Re-enter a recovered request under its ORIGINAL request_id and
        submit_time (validated once already).  ``emitted`` is the prefix
        the client already has: greedy decode regenerates it (a greedy
        stream depends on its own prompt alone) and ``emit_skip``
        suppresses its re-emission, so the stream resumes where it broke."""
        if req.request_id < 0:
            raise ValueError("requeue() needs a submitted request")
        req.emit_skip = len(emitted) if emitted else 0
        req.replay_expect = list(emitted) if emitted else None
        self.scheduler.submit(req)
        self.metrics.note_requeue(req.instance)
        if self.tracer.enabled:
            self.tracer.request_event(req.request_id, "requeue", instance=req.instance)
        return req.request_id

    def reset_metrics(self) -> ServerMetrics:
        """Fresh counters and windows (after a warm-up, say); re-points
        every part that holds the metrics object."""
        old = self.metrics
        self.metrics = self._new_metrics(old.slo)
        self.metrics.resilience_fn = old.resilience_fn
        self._wire_metrics()
        return self.metrics

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
