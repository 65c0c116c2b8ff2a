"""Deterministic fault injection for the serving stack (DESIGN.md §6.8;
port of ``repro.serving.resilience.faults``).

A ``FaultInjector`` holds a declarative *fault plan*: a list of
``FaultSpec`` entries, each naming a **site** (which call-counter it
watches), a **kind** (what happens when it fires), and a trigger
(``at_call`` / ``every`` / ``prob``).  The engine and driver consult the
injector at well-defined points; every consultation advances that
site's call counter, so with a fixed plan + seed the fault schedule is
a pure function of the call sequence — same seed ⇒ same faults ⇒ same
recovered streams, which is what makes the chaos suite deterministic.

Sites (what the counter counts):

- ``decode``     one fused decode+sample dispatch (``MultiModelServer.step``)
- ``prefill``    one chunked-prefill ``advance`` pass
- ``scatter``    one slot-surgery scatter of a finished prefill
- ``driver``     one AsyncEngine driver-loop iteration
- ``checkpoint`` one checkpoint ``restore`` read

Kinds:

- ``raise``  raise ``FaultInjected`` at the site (before the device
  call dispatches, so host/device state is never half-mutated)
- ``nan``    poison the logits' finite-mask for ``instance`` on this
  decode call — the host-side NaN/Inf guard then sees the row exactly
  as it would see real non-finite logits.  (Injecting real NaN into the
  cache would *persist* — 0·NaN=NaN survives masked attention — and
  poison every later step, so the injection flips the guard instead;
  the guard itself is computed on device from the real logits.)
- ``stall``  sleep ``stall_s`` seconds at the site (models a hung
  device call; the watchdog should fire)

The injector is **disarmed by default and zero-cost when disarmed**:
every call site is guarded by ``if injector.armed:`` so no injector
code runs at all (proven by the bombed-methods test, same discipline as
the tracer).
"""
from __future__ import annotations

import dataclasses
import json
import random
import time

SITES = ("decode", "prefill", "scatter", "driver", "checkpoint")

# what a mesh caller is told: the port's ranks are processes that each
# run the same host logic, so the periphery would have to fan every
# request out to every rank
MESH_PERIPHERY = ("the serving periphery (async frontend, supervisor, fault "
                  "injection) serves on one device; on a mesh it is a "
                  "ROADMAP item (Queue 1: the periphery on a mesh)")
KINDS = ("raise", "nan", "stall")


class FaultInjected(RuntimeError):
    """Raised by a firing ``raise``-kind fault."""

    def __init__(self, message: str, *, site: str = "", call: int = 0):
        super().__init__(message)
        self.site = site
        self.call = call


@dataclasses.dataclass
class FaultSpec:
    """One declarative fault.

    Exactly one trigger should be set: ``at_call`` (fire on the Nth
    call at the site, 1-based), ``every`` (fire on every Nth call), or
    ``prob`` (seeded Bernoulli per call).  ``times`` bounds total
    fires (default 1; ``None`` = unlimited).
    """

    site: str
    kind: str = "raise"
    at_call: int | None = None
    every: int | None = None
    prob: float | None = None
    instance: int = 0          # nan: which instance row to poison
    stall_s: float = 0.0       # stall: how long to sleep
    times: int | None = 1
    fired: int = 0             # runtime: how often this spec has fired

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(expected one of {SITES})")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")
        if self.at_call is None and not self.every and not self.prob:
            raise ValueError(f"fault {self.site}/{self.kind} needs a "
                             f"trigger: at_call, every, or prob")


class FaultInjector:
    """Seedable, deterministic fault injector.

    Construct with a plan (list of ``FaultSpec`` / dicts) and call
    ``arm()``; the engine's ``if faults.armed:`` guards then route each
    site through ``on_call``.  ``fired`` records ``(site, call_index,
    kind)`` tuples in firing order — the schedule fingerprint the
    determinism tests compare.
    """

    def __init__(self, plan=(), *, seed: int = 0):
        self.plan: list[FaultSpec] = [
            s if isinstance(s, FaultSpec) else FaultSpec(**s) for s in plan
        ]
        self.seed = seed
        self.armed = False
        self.calls: dict[str, int] = {}
        self.fired: list[tuple[str, int, str]] = []
        self._rng = random.Random(seed)

    # -- construction -------------------------------------------------
    @classmethod
    def from_plan(cls, plan: dict) -> "FaultInjector":
        """Build from the JSON plan schema:
        ``{"seed": 0, "faults": [{"site": ..., "kind": ..., ...}, ...]}``.
        """
        return cls(plan.get("faults", ()), seed=int(plan.get("seed", 0)))

    @classmethod
    def from_json(cls, text_or_path: str) -> "FaultInjector":
        """Accept a path to a plan file or an inline JSON literal."""
        text = text_or_path
        if not text.lstrip().startswith("{"):
            with open(text_or_path) as f:
                text = f.read()
        return cls.from_plan(json.loads(text))

    # -- lifecycle ----------------------------------------------------
    def arm(self) -> "FaultInjector":
        self.armed = True
        return self

    def disarm(self) -> None:
        self.armed = False

    def reset(self) -> None:
        """Rewind counters, spec fire-counts and the RNG to t=0 (the
        schedule replays identically)."""
        self.calls.clear()
        del self.fired[:]
        self._rng = random.Random(self.seed)
        for s in self.plan:
            s.fired = 0

    # -- the hot path (only ever reached when armed) ------------------
    def on_call(self, site: str) -> set[int]:
        """Count one call at ``site`` and apply matching faults.

        Returns the set of instance rows whose logits finite-mask
        should be poisoned for this call (empty normally; only ``nan``
        faults populate it).  ``raise`` faults raise ``FaultInjected``;
        ``stall`` faults sleep, then let the call proceed.
        """
        n = self.calls.get(site, 0) + 1
        self.calls[site] = n
        poison: set[int] = set()
        for spec in self.plan:
            if spec.site != site:
                continue
            if spec.times is not None and spec.fired >= spec.times:
                continue
            if spec.at_call is not None:
                hit = n == spec.at_call
            elif spec.every:
                hit = n % spec.every == 0
            else:
                hit = self._rng.random() < (spec.prob or 0.0)
            if not hit:
                continue
            spec.fired += 1
            self.fired.append((site, n, spec.kind))
            if spec.kind == "stall":
                time.sleep(spec.stall_s)
            elif spec.kind == "nan":
                poison.add(spec.instance)
            else:
                raise FaultInjected(
                    f"injected fault at {site} call {n}", site=site, call=n)
        return poison
