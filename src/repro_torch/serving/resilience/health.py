"""Per-instance health states (DESIGN.md §6.8; port of
``repro.serving.resilience.health``).

The fused grid's worst failure property is shared fate: one tenant's
poisoned weights would take down all M.  ``HealthMonitor`` contains the
blast radius to one grid *row*: each instance walks

    healthy → degraded → quarantined → probation → healthy

- **degraded**: ``degrade_after`` consecutive request failures.  Still
  admits; it is a warning state surfaced via /healthz.
- **quarantined**: a non-finite-logits (NaN/Inf) token — immediately —
  or ``quarantine_after`` consecutive failures.  The scheduler stops
  admitting to that row and ``try_submit`` answers ``model=i`` requests
  with a terminal ``unavailable`` Result (HTTP 503 + Retry-After); the
  other M−1 tenants are untouched.
- **probation**: after ``quarantine_steps`` engine steps the row may
  admit again, but one more failure re-quarantines with **doubled**
  duration (capped); one success restores healthy and resets the
  duration.

Durations are counted in *engine steps*, not wall time, so the
lifecycle is deterministic under test.
"""
from __future__ import annotations

import dataclasses

STATES = ("healthy", "degraded", "quarantined", "probation")


@dataclasses.dataclass
class _InstanceHealth:
    state: str = "healthy"
    consecutive_failures: int = 0
    failures: int = 0              # lifetime failed requests
    poisoned: int = 0              # lifetime NaN/Inf guard trips
    quarantine_left: int = 0       # steps until probation
    quarantine_len: int = 0        # current duration (doubles on re-trip)
    quarantines: int = 0           # lifetime quarantine entries


class HealthMonitor:
    def __init__(self, num_instances: int, *, degrade_after: int = 1,
                 quarantine_after: int = 3, quarantine_steps: int = 64,
                 max_quarantine_steps: int = 4096):
        self.degrade_after = degrade_after
        self.quarantine_after = quarantine_after
        self.quarantine_steps = quarantine_steps
        self.max_quarantine_steps = max_quarantine_steps
        self._inst = [_InstanceHealth() for _ in range(num_instances)]
        self.quarantine_events = 0
        # incident hook: called with the instance index on every FRESH
        # quarantine transition (not on extensions of an existing one).
        # The engine wires the flight recorder here (§6.9); None = no-op
        self.on_quarantine = None

    # -- queries ------------------------------------------------------
    def state(self, i: int) -> str:
        return self._inst[i].state

    def states(self) -> list[str]:
        return [st.state for st in self._inst]

    def admissible(self, i: int) -> bool:
        """May the scheduler admit (and the engine accept) requests for
        instance ``i``?"""
        return self._inst[i].state != "quarantined"

    def quarantined_now(self) -> int:
        return sum(1 for st in self._inst if st.state == "quarantined")

    # -- signals from the engine --------------------------------------
    def note_poisoned(self, i: int) -> None:
        """Instance ``i`` produced non-finite logits: quarantine now."""
        st = self._inst[i]
        st.poisoned += 1
        self._quarantine(st, i)

    def note_failure(self, i: int) -> None:
        """A request on instance ``i`` failed terminally."""
        st = self._inst[i]
        st.failures += 1
        st.consecutive_failures += 1
        if st.state == "probation":
            self._quarantine(st, i)
        elif st.consecutive_failures >= self.quarantine_after:
            self._quarantine(st, i)
        elif (st.state == "healthy"
              and st.consecutive_failures >= self.degrade_after):
            st.state = "degraded"

    def note_success(self, i: int) -> None:
        """A request on instance ``i`` completed normally."""
        st = self._inst[i]
        st.consecutive_failures = 0
        if st.state == "probation":
            st.state = "healthy"
            st.quarantine_len = 0      # full recovery resets the doubling
        elif st.state == "degraded":
            st.state = "healthy"

    def note_step(self) -> None:
        """One engine step elapsed: age quarantines toward probation."""
        for st in self._inst:
            if st.state == "quarantined":
                st.quarantine_left -= 1
                if st.quarantine_left <= 0:
                    st.state = "probation"

    def _quarantine(self, st: _InstanceHealth, i: int) -> None:
        st.consecutive_failures = 0
        st.quarantine_len = (
            self.quarantine_steps if st.quarantine_len == 0
            else min(st.quarantine_len * 2, self.max_quarantine_steps))
        st.quarantine_left = st.quarantine_len
        fresh = st.state != "quarantined"
        if fresh:
            st.quarantines += 1
            self.quarantine_events += 1
        st.state = "quarantined"
        if fresh and self.on_quarantine is not None:
            self.on_quarantine(i)

    # -- export -------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "states": self.states(),
            "quarantined_now": self.quarantined_now(),
            "quarantine_events": self.quarantine_events,
            "poisoned_tokens": sum(st.poisoned for st in self._inst),
            "failures": sum(st.failures for st in self._inst),
            "per_instance": [
                {
                    "state": st.state,
                    "consecutive_failures": st.consecutive_failures,
                    "failures": st.failures,
                    "poisoned": st.poisoned,
                    "quarantines": st.quarantines,
                    "quarantine_left": st.quarantine_left,
                }
                for st in self._inst
            ],
        }
