"""Step-level tracing for the fused serving engine (port of
``repro.serving.obs.trace``).

The engine's whole argument is GPU/TPU utilization — M merged instances
sharing one fused (M, B) program should beat M sequential programs — yet
until now the only figures were end-to-end tokens/s.  :class:`Tracer`
makes the per-step anatomy visible: every device call (fused decode
step, prefill chunk, slot scatter) becomes one ring-buffered event
carrying

* **wall vs settled time** — dispatch wall (host time to issue the
  launches) and settled wall (through the block's device-to-host copy
  or ``api.settle``, a ``torch.cuda.synchronize``), so host dispatch
  overhead separates from device execution,
* **dispatch gap** — host time since the previous device call settled:
  the per-step overhead that makes the fused path lose to the
  sequential baseline at small M (BENCH_serve.json ``speedup`` < 1),
* **grid occupancy** — active decoding (M, B) slots vs capacity, the
  paper's utilization claim made measurable per step, plus prefill
  lanes busy and the validity fraction of padded chunks,

and every request leaves a lifecycle trail (submit → admit →
prefill-done → finish/cancel) correlated by request id, exported as
spans.

Off by default and **free when off**: every engine call site guards on
``tracer.enabled`` before touching the tracer, so the disabled path
constructs no event objects, takes no locks, and reads no clocks
(tests assert zero event construction).  When on, events append to a
bounded ``deque`` under a lock (the async frontend runs steps on an
executor thread while ``GET /debug/trace`` exports from the event
loop), so capture cost is O(1) per device call and memory is capped by
``capacity``.

Exports:

* :meth:`Tracer.export_chrome` — Chrome-trace / Perfetto JSON
  (``chrome://tracing`` or https://ui.perfetto.dev): device calls on a
  ``device`` process (one track per call kind), request phases on a
  ``requests`` process (one track per request id),
* :meth:`Tracer.summary` — aggregates: dispatch-overhead p50/p95,
  mean grid occupancy, idle-slot token-steps, prefill-lane occupancy,
  chunk validity.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

DEFAULT_CAPACITY = 65536

# request lifecycle stages, in order; consecutive pairs become spans
STAGES = ("submit", "admit", "prefill_done", "finish")
TERMINAL = ("finish", "cancel")
# resilience stages (DESIGN.md §6.8): each occurrence renders as its
# own instant (a request can requeue more than once, a driver can
# restart more than once — these never collapse into lifecycle spans)
RECOVERY = ("requeue", "restart", "shed", "quarantine")


@dataclasses.dataclass
class DeviceCallEvent:
    """One device call: a fused decode step, a prefill chunk/tail call,
    or a prefill->grid slot scatter."""
    kind: str                  # "decode" | "prefill_chunk" | "scatter"
    t0: float                  # dispatch begin (tracer clock)
    t_dispatch: float          # dispatch returned (async call issued)
    t_settled: float           # outputs settled on the host
    gap_s: float               # host gap since the previous call settled
    step: int                  # engine step counter at the call
    active: int = 0            # decoding (M, B) slots at the call
    capacity: int = 0          # M * B
    lanes_busy: int = 0        # prefill lanes mid-admission
    lanes: int = 0             # total prefill lanes
    valid_frac: float = 1.0    # real positions / padded positions (chunks)
    tokens: int = 0            # real tokens this call advanced
    pending: int = 0           # queued requests at the call
    decode_steps: int = 1      # scan steps fused into this call (decode
                               # blocks, DESIGN.md §6.6; 1 otherwise)


@dataclasses.dataclass
class RequestEvent:
    """One request-lifecycle edge, correlated by request id."""
    rid: int
    stage: str                 # submit | admit | prefill_done | finish | cancel
    t: float
    instance: int = -1
    status: str | None = None  # terminal stages: ok/cancelled/expired/...


class Tracer:
    """Ring-buffered step tracer; disabled until :meth:`start`.

    Call sites MUST guard on ``tracer.enabled`` — the methods themselves
    assume capture is on (that keeps the disabled hot path at literal
    zero cost: one attribute read per guard)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock=time.perf_counter):
        self.enabled = False
        self.capacity = capacity
        self.clock = clock
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._epoch = 0.0          # clock at start(); event times relative
        self._last_settled: float | None = None
        self.dropped = 0           # events evicted by the ring bound

    # -- capture lifecycle ---------------------------------------------------

    def start(self) -> None:
        """Begin (or restart) capture; the ring and clock epoch reset so
        a fresh capture never mixes with a previous window."""
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._epoch = self.clock()
            self._last_settled = None
            self.enabled = True

    def stop(self) -> None:
        self.enabled = False

    def __len__(self) -> int:
        return len(self._events)

    def _append(self, ev) -> None:
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)

    # -- recording (call only when ``enabled``) ------------------------------

    def device_call(self, kind: str, t0: float, t_dispatch: float,
                    t_settled: float, *, step: int = 0, active: int = 0,
                    capacity: int = 0, lanes_busy: int = 0, lanes: int = 0,
                    valid_frac: float = 1.0, tokens: int = 0,
                    pending: int = 0, decode_steps: int = 1) -> None:
        """Record one device call; timestamps are raw ``clock()`` reads
        (the tracer rebases them onto its epoch)."""
        last = self._last_settled
        self._last_settled = t_settled
        self._append(DeviceCallEvent(
            kind, t0 - self._epoch, t_dispatch - self._epoch,
            t_settled - self._epoch,
            gap_s=(t0 - last) if last is not None else 0.0,
            step=step, active=active, capacity=capacity,
            lanes_busy=lanes_busy, lanes=lanes, valid_frac=valid_frac,
            tokens=tokens, pending=pending, decode_steps=decode_steps,
        ))

    def request_event(self, rid: int, stage: str, *, instance: int = -1,
                      status: str | None = None) -> None:
        self._append(RequestEvent(
            rid, stage, self.clock() - self._epoch, instance, status))

    # -- export --------------------------------------------------------------

    def _snapshot(self) -> list:
        with self._lock:
            return list(self._events)

    def export_chrome(self) -> dict:
        """The capture as Chrome-trace JSON (the ``traceEvents`` array
        format Perfetto and ``chrome://tracing`` load directly).

        Device calls render as complete ("X") slices on pid 0, one tid
        per call kind, with the dispatch gap and occupancy in ``args``;
        request lifecycles render on pid 1, one tid per request id, as
        one slice per completed phase (queued / prefill / decode) plus
        an instant ("i") event at terminal stages."""
        us = lambda t: t * 1e6
        kinds: dict[str, int] = {}
        events: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": "device"}},
            {"name": "process_name", "ph": "M", "pid": 1,
             "args": {"name": "requests"}},
        ]
        marks: dict[int, dict[str, RequestEvent]] = {}
        for ev in self._snapshot():
            if isinstance(ev, DeviceCallEvent):
                tid = kinds.setdefault(ev.kind, len(kinds))
                events.append({
                    "name": ev.kind, "ph": "X", "cat": "device",
                    "pid": 0, "tid": tid,
                    "ts": us(ev.t0), "dur": max(us(ev.t_settled - ev.t0), 0.0),
                    "args": {
                        "step": ev.step,
                        "dispatch_ms": 1e3 * (ev.t_dispatch - ev.t0),
                        "settled_ms": 1e3 * (ev.t_settled - ev.t0),
                        "gap_ms": 1e3 * ev.gap_s,
                        "active_slots": ev.active,
                        "slot_capacity": ev.capacity,
                        "occupancy": (ev.active / ev.capacity
                                      if ev.capacity else 0.0),
                        "lanes_busy": ev.lanes_busy,
                        "lanes": ev.lanes,
                        "valid_frac": ev.valid_frac,
                        "tokens": ev.tokens,
                        "pending": ev.pending,
                        "decode_steps": ev.decode_steps,
                    },
                })
            elif ev.stage in RECOVERY:
                # rendered immediately (not via marks): every
                # occurrence is its own instant, and rid -1 (driver
                # restarts) is not a request lifecycle
                events.append({
                    "name": (f"{ev.stage}:{ev.status}" if ev.status
                             else ev.stage),
                    "ph": "i", "cat": "resilience", "pid": 1,
                    "tid": ev.rid, "ts": us(ev.t), "s": "t",
                    "args": {"request_id": ev.rid,
                             "instance": ev.instance},
                })
            else:
                marks.setdefault(ev.rid, {})[ev.stage] = ev
        for tid, kind in sorted((v, k) for k, v in kinds.items()):
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": tid, "args": {"name": kind}})
        span_names = {("submit", "admit"): "queued",
                      ("admit", "prefill_done"): "prefill",
                      ("prefill_done", "finish"): "decode",
                      # zero-work admissions skip prefill_done; cancels
                      # can land in any phase — close with what exists
                      ("submit", "finish"): "request",
                      ("submit", "cancel"): "cancelled",
                      ("admit", "finish"): "serve",
                      ("admit", "cancel"): "cancelled",
                      ("prefill_done", "cancel"): "cancelled"}
        for rid, stages in marks.items():
            order = [s for s in
                     ("submit", "admit", "prefill_done", "finish", "cancel")
                     if s in stages]
            for a, b in zip(order, order[1:]):
                ea, eb = stages[a], stages[b]
                events.append({
                    "name": span_names.get((a, b), f"{a}->{b}"),
                    "ph": "X", "cat": "request", "pid": 1, "tid": rid,
                    "ts": us(ea.t), "dur": max(us(eb.t - ea.t), 0.0),
                    "args": {"request_id": rid, "instance": eb.instance
                             if eb.instance >= 0 else ea.instance},
                })
            for s in TERMINAL:
                if s in stages:
                    ev = stages[s]
                    events.append({
                        "name": f"{s}:{ev.status or 'ok'}", "ph": "i",
                        "cat": "request", "pid": 1, "tid": rid,
                        "ts": us(ev.t), "s": "t",
                        "args": {"request_id": rid, "status": ev.status},
                    })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def summary(self) -> dict:
        """Aggregate the capture: the figures BENCH_serve.json records
        and ``perf_delta --serve`` diffs across PRs."""
        # local import: metrics.py imports obs.slo at module scope, so a
        # module-level import here would close an import cycle through
        # the obs package __init__
        from repro_torch.serving.metrics import percentiles
        calls = [e for e in self._snapshot()
                 if isinstance(e, DeviceCallEvent)]
        decodes = [e for e in calls if e.kind == "decode"]
        chunks = [e for e in calls if e.kind == "prefill_chunk"]
        # the first call of a capture has no predecessor: gap 0 by
        # construction, harmless in the percentiles
        gaps = [e.gap_s for e in calls]
        occ = [e.active / e.capacity for e in decodes if e.capacity]
        decode_tokens = sum(e.tokens for e in decodes)
        decode_gap_s = sum(e.gap_s for e in decodes)
        out = {
            "device_calls": len(calls),
            "decode_steps": len(decodes),   # decode device calls (blocks)
            # multi-step decode (DESIGN.md §6.6): scan steps fused into
            # those calls, and the per-TOKEN dispatch cost — the figure
            # K-fold amortization actually improves (per-CALL overhead
            # stays flat while each call yields up to K*occupancy tokens)
            "decode_scan_steps": sum(e.decode_steps for e in decodes),
            "mean_decode_steps_per_call": (
                sum(e.decode_steps for e in decodes) / len(decodes)
                if decodes else 0.0),
            "dispatch_overhead_per_token_ms": (
                1e3 * decode_gap_s / decode_tokens
                if decode_tokens else None),
            "prefill_chunks": len(chunks),
            "scatters": sum(1 for e in calls if e.kind == "scatter"),
            # host time between device calls — the per-step dispatch
            # overhead the megakernel/multi-step-decode work must attack
            "dispatch_overhead_ms": percentiles(gaps),
            "mean_dispatch_gap_ms": (
                1e3 * sum(gaps) / len(gaps) if gaps else 0.0),
            "settled_ms": percentiles(
                [e.t_settled - e.t0 for e in calls]),
            # the utilization claim: decoding slots / grid capacity
            "mean_grid_occupancy": sum(occ) / len(occ) if occ else 0.0,
            # slot-steps the fused program computed for nobody (an idle
            # lane still rides every fused step)
            "idle_slot_token_steps": sum(
                e.capacity - e.active for e in decodes),
            "mean_prefill_lane_occupancy": (
                sum(e.lanes_busy / e.lanes for e in chunks if e.lanes)
                / len(chunks) if chunks else 0.0),
            "mean_chunk_validity": (
                sum(e.valid_frac for e in chunks) / len(chunks)
                if chunks else 0.0),
            "dropped_events": self.dropped,
        }
        return out
