"""Overload brownout policy (DESIGN.md §6.8; port of
``repro.serving.resilience.policy``).

Under sustained backpressure a server has three moves better than
hard-429ing everything: bound how often the supervisor retries a
request across crashes (poison-pill defense), shed the *oldest* queued
requests (whose clients have likely given up) with a ``Retry-After``,
and brown out — keep admitting but cap ``max_new_tokens`` so everyone
gets a shorter answer instead of some getting none.

The policy is plain host-side bookkeeping consulted by the engine once
per step (``note_depth`` + age shedding) and once per submit
(``cap_request``); it never touches device state.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class BrownoutPolicy:
    # retry budget: how often the Supervisor may requeue one request
    # across driver restarts before failing it terminally
    max_retries: int = 3
    # advisory client backoff for 429/503 responses, seconds
    retry_after_s: float = 1.0
    # shed queued requests older than this (None = never shed)
    shed_age_s: float | None = None
    # degraded mode: engaged after `degrade_steps` consecutive engine
    # steps with total queue depth >= `degrade_depth` (0 = disabled);
    # while engaged, submissions are capped to `degraded_max_new`
    degrade_depth: int = 0
    degrade_steps: int = 3
    degraded_max_new: int = 4

    # runtime state
    degraded: bool = False
    shed_total: int = 0
    capped_total: int = 0
    _over: int = 0

    def note_depth(self, total_pending: int) -> None:
        """One engine step's total queue depth: drive degraded mode."""
        if self.degrade_depth and total_pending >= self.degrade_depth:
            self._over += 1
            if self._over >= self.degrade_steps:
                self.degraded = True
        else:
            self._over = 0
            self.degraded = False

    def cap_request(self, req) -> bool:
        """In degraded mode, cap a submission's ``max_new_tokens``.
        Returns True if the request was capped."""
        if (self.degraded and self.degraded_max_new
                and req.max_new_tokens > self.degraded_max_new):
            req.max_new_tokens = self.degraded_max_new
            self.capped_total += 1
            return True
        return False

    def snapshot(self) -> dict:
        return {
            "degraded": self.degraded,
            "shed_total": self.shed_total,
            "capped_total": self.capped_total,
            "max_retries": self.max_retries,
            "retry_after_s": self.retry_after_s,
        }
