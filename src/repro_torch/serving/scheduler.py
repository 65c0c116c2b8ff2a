"""Policy-driven admission scheduling for the multi-model server (port
of ``repro.serving.scheduler``, single device).

One request stream per merged instance; once per engine step the engine
asks which pending requests to admit into the free slots:

* ``fifo`` — strict global arrival order (a head whose instance row is
  full is skipped over, not blocking other instances),
* ``round-robin`` — cycle instances, one request per instance per pass,
* ``token-budget`` — least-total-tokens-served instance first.

Policies are host-side bookkeeping only.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Mapping


@dataclasses.dataclass
class Request:
    instance: int                  # which fine-tuned model (task) this targets
    prompt: list[int]
    max_new_tokens: int = 16
    request_id: int = -1
    submit_time: float = 0.0       # host clock at submit (metrics)
    _seq: int = -1                 # global arrival index (scheduler-owned)


@dataclasses.dataclass
class Result:
    request_id: int
    instance: int
    tokens: list[int]              # generated tokens (excluding prompt)
    prompt_len: int = 0
    latency_s: float = 0.0
    status: str = "ok"             # ok | rejected | cancelled
    error: str | None = None
    finish_reason: str | None = None   # "stop" (EOS) or "length"


class Scheduler:
    """Base: per-instance FIFO queues + an admission policy in select()."""

    name = "base"

    def __init__(self, num_instances: int):
        self.m = num_instances
        self.queues: list[deque[Request]] = [deque() for _ in range(num_instances)]
        self._arrival = itertools.count()

    def submit(self, req: Request) -> None:
        if not 0 <= req.instance < self.m:
            raise ValueError(f"instance {req.instance} out of range [0, {self.m})")
        req._seq = next(self._arrival)
        self.queues[req.instance].append(req)

    def depth(self, instance: int) -> int:
        return len(self.queues[instance])

    def total_pending(self) -> int:
        return sum(len(q) for q in self.queues)

    def cancel(self, request_id: int) -> Request | None:
        """Remove a still-queued request; return it, or None."""
        for q in self.queues:
            for req in q:
                if req.request_id == request_id:
                    q.remove(req)
                    return req
        return None

    def note_generated(self, instance: int, n: int) -> None:
        pass

    def select(self, free: Mapping[int, int],
               limit: int | None = None) -> list[Request]:
        """Pop and return the requests to admit this round: never more than
        ``free[m]`` per instance and ``limit`` in total."""
        raise NotImplementedError


class FIFOScheduler(Scheduler):
    name = "fifo"

    def select(self, free, limit=None):
        budget = dict(free)
        out = []
        while limit is None or len(out) < limit:
            heads = [q[0] for q in self.queues
                     if q and budget.get(q[0].instance, 0) > 0]
            if not heads:
                break
            req = min(heads, key=lambda r: r._seq)
            self.queues[req.instance].popleft()
            budget[req.instance] -= 1
            out.append(req)
        return out


class RoundRobinScheduler(Scheduler):
    name = "round-robin"

    def __init__(self, num_instances: int):
        super().__init__(num_instances)
        self._cursor = 0

    def select(self, free, limit=None):
        budget = dict(free)
        out = []
        progressed = True
        while progressed:
            progressed = False
            for off in range(self.m):
                if limit is not None and len(out) >= limit:
                    self._cursor = (self._cursor + off) % self.m
                    return out
                i = (self._cursor + off) % self.m
                if self.queues[i] and budget.get(i, 0) > 0:
                    out.append(self.queues[i].popleft())
                    budget[i] -= 1
                    progressed = True
            if progressed:
                self._cursor = (self._cursor + 1) % self.m
        return out


class TokenBudgetScheduler(Scheduler):
    """Least-total-tokens-served instance first: prompts are charged at
    admission, generated tokens as the engine reports them."""

    name = "token-budget"

    def __init__(self, num_instances: int):
        super().__init__(num_instances)
        self.served = [0] * num_instances

    def note_generated(self, instance: int, n: int) -> None:
        self.served[instance] += n

    def select(self, free, limit=None):
        budget = dict(free)
        out = []
        while limit is None or len(out) < limit:
            ready = [i for i in range(self.m)
                     if self.queues[i] and budget.get(i, 0) > 0]
            if not ready:
                break
            i = min(ready, key=lambda j: (self.served[j], j))
            req = self.queues[i].popleft()
            self.served[i] += len(req.prompt)
            out.append(req)
            budget[i] -= 1
        return out


POLICIES = {
    c.name: c for c in (FIFOScheduler, RoundRobinScheduler, TokenBudgetScheduler)
}


def make_scheduler(policy: str, num_instances: int) -> Scheduler:
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; known: {sorted(POLICIES)}")
    return POLICIES[policy](num_instances)
