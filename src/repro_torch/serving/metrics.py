"""Per-instance serving metrics (port of ``repro.serving.metrics``).

The paper's deployment scenario is M task streams through one fused
program; operators need to see each task's share.  ``ServerMetrics``
keeps cheap host-side counters per instance — throughput, latency,
time-to-first-token, inter-token latency, queue depth — plus engine-wide
counters (fused decode steps, prefill batches/compiles).  TTFT and ITL
percentiles come from always-on log-bucketed histograms
(``obs/slo.py``): unlike the old bounded sample windows — which evict
the oldest samples and so report the tail of the last few minutes, not
of the run — histogram p50/p95/p99 are unbiased over the whole window
at O(buckets) memory, and export as real Prometheus ``histogram``
families.  The bounded deques remain as a last-N DEBUG view
(``ttft_recent_ms``) and as the sliding window the SLO burn-rate math
wants (§6.9).  ``snapshot()`` returns plain dicts (JSON-able);
``format_table()`` renders the per-instance report printed by
``repro_torch.launch.serve``.  Beside the reference's keys the snapshot
carries ``decode_ms_per_step``, and on a mesh its shape and the
throughput per device.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable

from repro_torch.serving.obs.slo import (
    LogHistogram,
    SLOConfig,
    evaluate_availability,
    evaluate_objective,
    worst_state,
)

# per-instance last-N latency window: the recent/debug view and the SLO
# burn-rate window — percentiles come from the histograms
MAX_LATENCY_SAMPLES = 4096


def percentiles(samples, scale: float = 1e3) -> dict | None:
    """p50/p95/p99 of ``samples`` (nearest-rank), scaled (default s->ms);
    None when there are no samples — JSON-able either way."""
    if not samples:
        return None
    xs = sorted(samples)
    n = len(xs)

    def q(p):
        return scale * xs[min(n - 1, max(0, -(-p * n // 100) - 1))]

    return {"p50": q(50), "p95": q(95), "p99": q(99)}


@dataclasses.dataclass
class InstanceStats:
    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    cancelled: int = 0             # client cancel / disconnect / expiry
    rejected: int = 0              # failed submit-time validation (also
    #                              # counts quarantine 503s)
    failed: int = 0                # terminally errored after admission
    #                              # (device-call failure / NaN guard)
    shed: int = 0                  # dropped from queue by brownout
    requeued: int = 0              # crash-recovery re-submissions
    prompt_tokens: int = 0
    generated_tokens: int = 0
    queue_depth: int = 0           # current, updated on submit/admit
    queue_peak: int = 0
    ttft_sum: float = 0.0          # submit -> first generated token
    ttft_n: int = 0
    latency_sum: float = 0.0       # submit -> completion
    latency_n: int = 0
    ttft_samples: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=MAX_LATENCY_SAMPLES))
    itl_samples: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=MAX_LATENCY_SAMPLES))
    # unbounded-run percentiles + Prometheus histogram exposition
    ttft_hist: LogHistogram = dataclasses.field(default_factory=LogHistogram)
    itl_hist: LogHistogram = dataclasses.field(default_factory=LogHistogram)


class ServerMetrics:
    def __init__(self, num_instances: int, mesh_shape: dict | None = None, *,
                 clock: Callable[[], float] = time.perf_counter,
                 slo: SLOConfig | None = None):
        self.m = num_instances
        self.clock = clock
        # per-instance SLO objectives (§6.9); None = not configured
        # (snapshot carries no "slo" block, /v1/slo reports unconfigured)
        self.slo = slo
        self.per_instance = [InstanceStats() for _ in range(num_instances)]
        self.decode_steps = 0        # fused (M, B)-grid decode+sample steps
        self.decode_calls = 0        # fused decode device calls (blocks of
                                     # up to K scan steps — DESIGN.md §6.6;
                                     # == decode_steps when K == 1)
        self.decode_tokens = 0       # real tokens emitted by those calls
        self.decode_wall_s = 0.0     # settled wall inside those calls
                                     # (dispatch -> tokens on host)
        self.decode_dispatch_s = 0.0  # host dispatch slice of that wall
                                      # (call -> last launch issued) — the cost
                                      # K-step blocks amortize K-fold
        self.prefill_batches = 0     # chunk/tail prefill device calls
        self.prefill_requests = 0    # lane-steps served by them
        self.prefill_tokens = 0      # real (non-padded) positions prefilled
        self.prefill_wall_s = 0.0    # settled wall time inside advance()
        self.scatter_calls = 0       # prefill-lane -> grid-slot scatters
        self.admitted = 0            # requests bound to a prefill lane
        # live view of the prefill runtime's compiled-shape count (the
        # engine wires a callable so snapshots can spot a recompile
        # regression without serve_bench's out-of-band bookkeeping; a
        # fresh window after reset_metrics still reads the true
        # cumulative count)
        self.compiled_shapes_fn: Callable[[], int] | None = None
        # wall time decode-ready slots sat idle while admission chunks
        # ran — what the engine's chunk_budget bounds per step
        self.admission_stall_s = 0.0
        # resilience (DESIGN.md §6.8): the Supervisor wires a snapshot
        # callable (restarts/retries/watchdog counters); the health
        # monitor likewise.  Unwired, snapshots carry zeros/None so the
        # Prometheus rows are always present
        self.resilience_fn: Callable[[], dict] | None = None
        self.health_fn: Callable[[], dict] | None = None
        # per-tenant attribution (§6.9): the engine wires
        # TenantAccounting.snapshot; unwired or disabled, snapshots
        # carry no "accounting" block
        self.accounting_fn: Callable[[], dict] | None = None
        self.replayed_tokens = 0     # regenerated with emission suppressed
        self.replay_mismatches = 0   # replayed token != delivered prefix
        self.started = clock()
        # per-request arrival time of the previous token (ITL deltas);
        # entries live exactly as long as the request decodes
        self._last_token_t: dict[int, float] = {}
        # the async frontend runs the step loop (note_token appends) on
        # an executor thread while snapshot() may serve GET /metrics on
        # the event-loop thread — guard the sample windows so iteration
        # never races an append
        self._lock = threading.Lock()
        # {"data": D, "model": T} on a mesh, None on one device: snapshots
        # then carry the throughput per device
        self.mesh_shape = mesh_shape
        self.num_devices = (1 if mesh_shape is None
                            else mesh_shape["data"] * mesh_shape["model"])

    # -- engine hooks --------------------------------------------------------

    def note_submit(self, instance: int) -> None:
        st = self.per_instance[instance]
        st.submitted += 1
        st.queue_depth += 1
        st.queue_peak = max(st.queue_peak, st.queue_depth)

    def note_reject(self, instance: int) -> None:
        if 0 <= instance < self.m:
            self.per_instance[instance].rejected += 1

    def note_admit(self, instance: int, prompt_len: int) -> None:
        st = self.per_instance[instance]
        st.admitted += 1
        st.queue_depth -= 1
        st.prompt_tokens += prompt_len
        self.admitted += 1

    def note_prefill_batch(self, num_requests: int, num_tokens: int = 0) -> None:
        self.prefill_batches += 1
        self.prefill_requests += num_requests
        self.prefill_tokens += num_tokens

    def note_prefill_wall(self, seconds: float) -> None:
        self.prefill_wall_s += seconds

    def note_decode_call(self, steps: int = 1, tokens: int = 0,
                         wall_s: float = 0.0,
                         dispatch_s: float = 0.0) -> None:
        """One fused decode device call covering ``steps`` scan steps
        and emitting ``tokens`` real (non-frozen-lane) tokens over
        ``wall_s`` seconds of settled dispatch-to-host wall time, of
        which ``dispatch_s`` was spent on host-side dispatch."""
        self.decode_calls += 1
        self.decode_steps += steps
        self.decode_tokens += tokens
        self.decode_wall_s += wall_s
        self.decode_dispatch_s += dispatch_s

    def note_scatter(self) -> None:
        self.scatter_calls += 1

    def note_admission_stall(self, seconds: float) -> None:
        self.admission_stall_s += seconds

    def note_token(self, instance: int, *, first: bool, submit_time: float,
                   request_id: int | None = None) -> None:
        st = self.per_instance[instance]
        st.generated_tokens += 1
        now = self.clock()
        with self._lock:
            if first:
                ttft = now - submit_time
                st.ttft_sum += ttft
                st.ttft_n += 1
                st.ttft_samples.append(ttft)
                st.ttft_hist.record(ttft)
            elif request_id is not None and request_id in self._last_token_t:
                itl = now - self._last_token_t[request_id]
                st.itl_samples.append(itl)
                st.itl_hist.record(itl)
            if request_id is not None:
                self._last_token_t[request_id] = now

    def note_complete(self, instance: int, submit_time: float,
                      request_id: int | None = None) -> None:
        st = self.per_instance[instance]
        st.completed += 1
        st.latency_sum += self.clock() - submit_time
        st.latency_n += 1
        if request_id is not None:
            self._last_token_t.pop(request_id, None)

    def note_cancel(self, instance: int, *, queued: bool,
                    request_id: int | None = None) -> None:
        """A request left the system without completing (client cancel,
        disconnect, deadline expiry) — from the queue (``queued=True``,
        still counted in queue_depth) or from a prefill lane / decode
        slot (already admitted)."""
        if 0 <= instance < self.m:
            st = self.per_instance[instance]
            st.cancelled += 1
            if queued:
                st.queue_depth -= 1
        if request_id is not None:
            self._last_token_t.pop(request_id, None)

    def note_failed(self, instance: int,
                    request_id: int | None = None) -> None:
        """A request failed terminally after admission (device-call
        failure or NaN/Inf guard)."""
        if 0 <= instance < self.m:
            self.per_instance[instance].failed += 1
        if request_id is not None:
            self._last_token_t.pop(request_id, None)

    def note_shed(self, instance: int) -> None:
        """A queued request was dropped by overload brownout."""
        st = self.per_instance[instance]
        st.shed += 1
        st.queue_depth -= 1

    def note_requeue(self, instance: int) -> None:
        """A recovered request re-entered its queue after a restart."""
        st = self.per_instance[instance]
        st.requeued += 1
        st.queue_depth += 1

    def note_replay(self, instance: int) -> None:
        """One already-delivered token regenerated with emission
        suppressed during recovery replay."""
        self.replayed_tokens += 1

    def reset_queue_depths(self) -> None:
        """Crash recovery: queues were drained wholesale, gauges follow
        (requeues re-increment them)."""
        for st in self.per_instance:
            st.queue_depth = 0

    # -- reporting -----------------------------------------------------------

    def slo_report(self) -> dict:
        """Per-instance SLO evaluation (the ``/v1/slo`` payload and the
        snapshot's ``"slo"`` block).  Lazy by construction: nothing is
        computed until someone asks, so configuring SLOs adds ZERO
        hot-path work — the inputs (histograms, recent windows,
        completion counters) are recorded regardless."""
        if self.slo is None:
            return {"configured": False}
        cfg = self.slo
        instances = []
        for st in self.per_instance:
            with self._lock:
                ttft_hist = st.ttft_hist
                itl_hist = st.itl_hist
                recent_ttft = list(st.ttft_samples)
                recent_itl = list(st.itl_samples)
                objectives = {}
                if cfg.ttft_ms is not None:
                    objectives["ttft"] = evaluate_objective(
                        ttft_hist, recent_ttft, cfg.ttft_ms, cfg.target)
                if cfg.itl_ms is not None:
                    objectives["itl"] = evaluate_objective(
                        itl_hist, recent_itl, cfg.itl_ms, cfg.target)
            objectives["availability"] = evaluate_availability(
                st.completed, st.failed, cfg.availability_target)
            instances.append({
                "objectives": objectives,
                "state": worst_state(o["state"] for o in objectives.values()),
            })
        return {
            "configured": True,
            "config": {"ttft_ms": cfg.ttft_ms, "itl_ms": cfg.itl_ms,
                       "target": cfg.target,
                       "availability_target": cfg.availability_target},
            "instances": instances,
        }

    def slo_states(self) -> list | None:
        """Per-instance worst-objective state, or None when no SLOs are
        configured (the /healthz and /v1/models summary)."""
        if self.slo is None:
            return None
        return [i["state"] for i in self.slo_report()["instances"]]

    def snapshot(self) -> dict:
        dt = max(self.clock() - self.started, 1e-9)
        inst = []
        agg_ttft = LogHistogram()
        agg_itl = LogHistogram()
        for st in self.per_instance:
            with self._lock:
                ttft_samples = list(st.ttft_samples)
                itl_samples = list(st.itl_samples)
                ttft_pct = st.ttft_hist.percentiles()
                itl_pct = st.itl_hist.percentiles()
                ttft_hist = st.ttft_hist.snapshot()
                itl_hist = st.itl_hist.snapshot()
                agg_ttft.merge(st.ttft_hist)
                agg_itl.merge(st.itl_hist)
            inst.append({
                "submitted": st.submitted,
                "admitted": st.admitted,
                "completed": st.completed,
                "cancelled": st.cancelled,
                "rejected": st.rejected,
                "failed": st.failed,
                "shed": st.shed,
                "requeued": st.requeued,
                "queue_depth": st.queue_depth,
                "queue_peak": st.queue_peak,
                "prompt_tokens": st.prompt_tokens,
                "generated_tokens": st.generated_tokens,
                "tok_per_s": st.generated_tokens / dt,
                "mean_ttft_s": st.ttft_sum / st.ttft_n if st.ttft_n else None,
                "mean_latency_s": st.latency_sum / st.latency_n if st.latency_n else None,
                # unbiased whole-run percentiles (log-bucketed histogram)
                "ttft_ms": ttft_pct,
                "itl_ms": itl_pct,
                # Prometheus histogram exposition source
                "ttft_hist": ttft_hist,
                "itl_hist": itl_hist,
                # last-N debug view (the OLD windowed estimator, kept for
                # "what happened just now" — biased on long runs by design)
                "ttft_recent_ms": percentiles(ttft_samples),
                "itl_recent_ms": percentiles(itl_samples),
            })
        gen = sum(s.generated_tokens for s in self.per_instance)
        # split throughput over each phase's own settled device wall:
        # prefill rate over advance()'s wall, decode rate over the decode
        # blocks' dispatch->host wall (engine times every fused call) —
        # scheduler/scatter/host-unroll time belongs to neither phase.
        # Fallback for synthetic windows with no timed calls: the
        # pre-§6.6 wall split (everything-but-prefill)
        decode_wall = (self.decode_wall_s if self.decode_wall_s > 0
                       else max(dt - self.prefill_wall_s, 1e-9))
        out = {
            "wall_s": dt,
            "decode_steps": self.decode_steps,
            # multi-step decode (DESIGN.md §6.6): device calls vs scan
            # steps vs tokens — tokens_per_device_call is the K*occupancy
            # dispatch-amortization figure /metrics exposes
            "decode_device_calls": self.decode_calls,
            "tokens_per_device_call": (
                self.decode_tokens / self.decode_calls
                if self.decode_calls else 0.0
            ),
            "prefill_batches": self.prefill_batches,
            "prefill_requests": self.prefill_requests,
            "prefill_tokens": self.prefill_tokens,
            "prefill_wall_s": self.prefill_wall_s,
            "prefill_tok_per_s": (
                self.prefill_tokens / self.prefill_wall_s
                if self.prefill_wall_s > 0 else 0.0
            ),
            "decode_wall_s": self.decode_wall_s,
            "decode_ms_per_step": (1e3 * self.decode_wall_s / self.decode_steps
                                   if self.decode_steps else 0.0),
            "decode_tok_per_s": (self.decode_tokens if self.decode_wall_s > 0
                                 else gen) / decode_wall,
            # host-dispatch cost per emitted token — the figure multi-step
            # blocks shrink ~K-fold (DESIGN.md §6.6)
            "decode_dispatch_ms_per_token": (
                1e3 * self.decode_dispatch_s / self.decode_tokens
                if self.decode_tokens else 0.0
            ),
            "device_calls_per_admission": (
                self.prefill_batches / self.admitted if self.admitted else 0.0
            ),
            # cumulative device-call + compiled-shape counters: /metrics
            # alone is enough to spot a recompile or dispatch regression
            "scatter_calls": self.scatter_calls,
            "device_calls": (self.decode_calls + self.prefill_batches
                             + self.scatter_calls),
            "prefill_compiled_shapes": (
                self.compiled_shapes_fn() if self.compiled_shapes_fn
                is not None else None
            ),
            "admission_stall_ms": 1e3 * self.admission_stall_s,
            "generated_tokens": gen,
            "tok_per_s": gen / dt,
            "cancelled": sum(s.cancelled for s in self.per_instance),
            "rejected": sum(s.rejected for s in self.per_instance),
            "failed": sum(s.failed for s in self.per_instance),
            "shed": sum(s.shed for s in self.per_instance),
            "requeued": sum(s.requeued for s in self.per_instance),
            "replayed_tokens": self.replayed_tokens,
            "replay_mismatches": self.replay_mismatches,
            # supervision counters: zeros when no Supervisor is wired, so
            # the Prometheus exposition always carries the rows
            "resilience": (
                self.resilience_fn() if self.resilience_fn is not None
                else {"driver_restarts": 0, "request_retries": 0,
                      "watchdog_timeouts": 0, "tokens_replayed": 0,
                      "retry_budget_exhausted": 0,
                      "last_recovery_s": None, "recoveries": []}
            ),
            "health": (
                self.health_fn() if self.health_fn is not None else None
            ),
            "ttft_ms": agg_ttft.percentiles(),
            "itl_ms": agg_itl.percentiles(),
            "instances": inst,
        }
        if self.slo is not None:
            out["slo"] = self.slo_report()
        if self.accounting_fn is not None:
            acct = self.accounting_fn()
            # carried once there is (or was) a capture window — an
            # engine whose accounting never started adds no block
            if acct.get("enabled") or acct.get("settled_s", 0.0) > 0:
                out["accounting"] = acct
        if self.mesh_shape is not None:
            out["mesh"] = {
                "shape": dict(self.mesh_shape), "devices": self.num_devices,
            }
            out["tok_per_s_per_device"] = gen / dt / self.num_devices
        return out

    def format_table(self) -> str:
        snap = self.snapshot()
        hdr = (
            f"{'inst':>4} {'done':>5} {'can':>4} {'queue':>5} {'peak':>5} "
            f"{'prompt':>7} {'gen':>7} {'tok/s':>8} "
            f"{'ttft50':>7} {'ttft95':>7} {'itl50':>7} {'itl95':>7} {'lat_ms':>8}"
        )
        rows = [hdr, "-" * len(hdr)]

        def pct(d, key):
            return f"{d[key]:.1f}" if d is not None else "-"

        for i, st in enumerate(snap["instances"]):
            lat = f"{1e3 * st['mean_latency_s']:.1f}" if st["mean_latency_s"] is not None else "-"
            rows.append(
                f"{i:>4} {st['completed']:>5} {st['cancelled']:>4} "
                f"{st['queue_depth']:>5} {st['queue_peak']:>5} "
                f"{st['prompt_tokens']:>7} {st['generated_tokens']:>7} "
                f"{st['tok_per_s']:>8.1f} "
                f"{pct(st['ttft_ms'], 'p50'):>7} {pct(st['ttft_ms'], 'p95'):>7} "
                f"{pct(st['itl_ms'], 'p50'):>7} {pct(st['itl_ms'], 'p95'):>7} "
                f"{lat:>8}"
            )
        rows.append(
            f"total: {snap['generated_tokens']} tokens in {snap['wall_s']:.2f}s "
            f"({snap['tok_per_s']:.1f} tok/s) — {snap['decode_steps']} fused decode "
            f"steps in {snap['decode_device_calls']} device calls "
            f"({snap['tokens_per_device_call']:.1f} tok/call, "
            f"{snap['decode_ms_per_step']:.2f} ms/step), "
            f"{snap['prefill_batches']} prefill chunk calls "
            f"({snap['prefill_requests']} lane-steps, "
            f"{snap['device_calls_per_admission']:.2f} calls/admission), "
            f"prefill {snap['prefill_tok_per_s']:.1f} tok/s / "
            f"decode {snap['decode_tok_per_s']:.1f} tok/s, "
            f"{snap['admission_stall_ms']:.1f} ms admission stall"
        )
        if snap["ttft_ms"] is not None:
            t, it = snap["ttft_ms"], snap["itl_ms"]
            itl = (
                f"itl p50/p95/p99 {it['p50']:.1f}/{it['p95']:.1f}/{it['p99']:.1f} ms"
                if it is not None else "itl -"
            )
            rows.append(
                f"tails: ttft p50/p95/p99 "
                f"{t['p50']:.1f}/{t['p95']:.1f}/{t['p99']:.1f} ms, {itl}"
            )
        return "\n".join(rows)
