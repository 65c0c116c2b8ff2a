"""Per-instance serving metrics (port of ``repro.serving.metrics``: the
counters and percentiles the serve CLI prints).

Percentiles are nearest-rank over every sample of the run.
"""
from __future__ import annotations

import dataclasses
import time


def percentiles(samples, scale: float = 1e3) -> dict | None:
    """p50/p95/p99 of ``samples`` (nearest-rank), scaled (default s->ms)."""
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
    cancelled: int = 0
    rejected: int = 0
    prompt_tokens: int = 0
    generated_tokens: int = 0
    queue_depth: int = 0
    queue_peak: int = 0
    ttft_samples: list = dataclasses.field(default_factory=list)
    itl_samples: list = dataclasses.field(default_factory=list)
    latency_samples: list = dataclasses.field(default_factory=list)


class ServerMetrics:
    def __init__(self, num_instances: int):
        self.m = num_instances
        self.clock = time.perf_counter
        self.per_instance = [InstanceStats() for _ in range(num_instances)]
        self.decode_steps = 0        # (M, B)-grid decode+sample steps
        self.decode_calls = 0        # K-step blocks (one dispatch each)
        self.decode_tokens = 0       # real tokens emitted by those calls
        self.decode_wall_s = 0.0     # dispatch -> tokens on the host
        self.prefill_batches = 0     # chunk calls
        self.prefill_requests = 0    # lane-steps served by them
        self.prefill_tokens = 0      # real (non-padded) positions prefilled
        self.prefill_wall_s = 0.0    # settled wall inside advance()
        self.scatter_calls = 0
        self.admitted = 0
        self.admission_stall_s = 0.0
        self.started = self.clock()
        self._last_token_t: dict[int, float] = {}

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

    def note_decode_call(self, steps: int, tokens: int, wall_s: float) -> None:
        self.decode_calls += 1
        self.decode_steps += steps
        self.decode_tokens += tokens
        self.decode_wall_s += wall_s

    def note_scatter(self) -> None:
        self.scatter_calls += 1

    def note_admission_stall(self, seconds: float) -> None:
        self.admission_stall_s += seconds

    def note_token(self, instance: int, *, first: bool, submit_time: float,
                   request_id: int) -> None:
        st = self.per_instance[instance]
        st.generated_tokens += 1
        now = self.clock()
        if first:
            st.ttft_samples.append(now - submit_time)
        elif request_id in self._last_token_t:
            st.itl_samples.append(now - self._last_token_t[request_id])
        self._last_token_t[request_id] = now

    def note_complete(self, instance: int, submit_time: float, request_id: int) -> None:
        st = self.per_instance[instance]
        st.completed += 1
        st.latency_samples.append(self.clock() - submit_time)
        self._last_token_t.pop(request_id, None)

    def note_cancel(self, instance: int, *, queued: bool, request_id: int) -> None:
        st = self.per_instance[instance]
        st.cancelled += 1
        if queued:
            st.queue_depth -= 1
        self._last_token_t.pop(request_id, None)

    def snapshot(self) -> dict:
        dt = max(self.clock() - self.started, 1e-9)
        inst = []
        for st in self.per_instance:
            inst.append({
                "submitted": st.submitted, "admitted": st.admitted,
                "completed": st.completed, "cancelled": st.cancelled,
                "rejected": st.rejected, "queue_depth": st.queue_depth,
                "queue_peak": st.queue_peak, "prompt_tokens": st.prompt_tokens,
                "generated_tokens": st.generated_tokens,
                "tok_per_s": st.generated_tokens / dt,
                "ttft_ms": percentiles(st.ttft_samples),
                "itl_ms": percentiles(st.itl_samples),
                "latency_ms": percentiles(st.latency_samples),
            })
        gen = sum(s.generated_tokens for s in self.per_instance)
        return {
            "wall_s": dt,
            "decode_steps": self.decode_steps,
            "decode_device_calls": self.decode_calls,
            "tokens_per_device_call": (self.decode_tokens / self.decode_calls
                                       if self.decode_calls else 0.0),
            "decode_wall_s": self.decode_wall_s,
            "decode_tok_per_s": (self.decode_tokens / self.decode_wall_s
                                 if self.decode_wall_s > 0 else 0.0),
            "decode_ms_per_step": (1e3 * self.decode_wall_s / self.decode_steps
                                   if self.decode_steps else 0.0),
            "prefill_batches": self.prefill_batches,
            "prefill_requests": self.prefill_requests,
            "prefill_tokens": self.prefill_tokens,
            "prefill_wall_s": self.prefill_wall_s,
            "prefill_tok_per_s": (self.prefill_tokens / self.prefill_wall_s
                                  if self.prefill_wall_s > 0 else 0.0),
            "scatter_calls": self.scatter_calls,
            "admission_stall_ms": 1e3 * self.admission_stall_s,
            "generated_tokens": gen,
            "tok_per_s": gen / dt,
            "ttft_ms": percentiles([x for s in self.per_instance for x in s.ttft_samples]),
            "itl_ms": percentiles([x for s in self.per_instance for x in s.itl_samples]),
            "instances": inst,
        }

    def format_table(self) -> str:
        snap = self.snapshot()
        hdr = (f"{'inst':>4} {'done':>5} {'can':>4} {'peak':>5} {'prompt':>7} "
               f"{'gen':>7} {'tok/s':>8} {'ttft50':>7} {'ttft95':>7} "
               f"{'itl50':>7} {'itl95':>7}")
        rows = [hdr, "-" * len(hdr)]

        def pct(d, key):
            return f"{d[key]:.1f}" if d is not None else "-"

        for i, st in enumerate(snap["instances"]):
            rows.append(
                f"{i:>4} {st['completed']:>5} {st['cancelled']:>4} "
                f"{st['queue_peak']:>5} {st['prompt_tokens']:>7} "
                f"{st['generated_tokens']:>7} {st['tok_per_s']:>8.1f} "
                f"{pct(st['ttft_ms'], 'p50'):>7} {pct(st['ttft_ms'], 'p95'):>7} "
                f"{pct(st['itl_ms'], 'p50'):>7} {pct(st['itl_ms'], 'p95'):>7}")
        rows.append(
            f"total: {snap['generated_tokens']} tokens in {snap['wall_s']:.2f}s "
            f"({snap['tok_per_s']:.1f} tok/s) — {snap['decode_steps']} decode "
            f"steps in {snap['decode_device_calls']} blocks "
            f"({snap['decode_ms_per_step']:.2f} ms/step), "
            f"{snap['prefill_batches']} prefill chunk calls, prefill "
            f"{snap['prefill_tok_per_s']:.1f} tok/s, "
            f"{snap['admission_stall_ms']:.1f} ms admission stall")
        return "\n".join(rows)
