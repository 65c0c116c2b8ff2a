"""Per-tenant wall-time attribution for the fused (M, B) grid (§6.9;
port of ``repro.serving.obs.accounting``).

The engine's whole design concentrates M tenants' work into ONE device
call per step — which is exactly why per-call telemetry (§6.5) cannot
answer the question a multi-tenant operator actually asks: *how much of
the device did tenant i consume, and who made tenant j wait?*
:class:`TenantAccounting` splits every settled device call's wall time
across the instances occupying that call:

* **decode** — a fused (M, B) decode block costs ``wall`` regardless of
  occupancy, so each of the ``capacity = M*B`` slot-shares costs
  ``wall / capacity``: instance i is charged ``active_i`` shares into
  its ``decode_s`` account and its ``B - active_i`` empty slots into
  ``idle_s`` (the waste an idle lane still rides — the paper's
  utilization argument, priced per tenant);
* **prefill chunk** — lane-weighted the same way (``wall / lanes`` per
  lane); lanes nobody occupied are shared idle, split evenly across
  the M tenants (unused shared capacity is a cost of the fused design,
  not of any one tenant);
* **scatter** — a slot-admission call serves exactly one request:
  whole wall to its instance;
* **queue wait / replay** — host-side accounts: time a request sat
  queued before admission, and the token-weighted share of decode wall
  spent regenerating already-delivered tokens after a crash (§6.8
  replay).  Replay is a *view* over decode time (those calls are also
  attributed normally), so it is excluded from conservation;
* **interference** — while tenant w had requests queued, every settled
  call's wall is attributed to the tenants occupying the grid at that
  moment, occupancy-weighted: "w waited 3.1 s; 2.9 s of that the grid
  was running tenant 0" — the head-of-line report.

**Conservation invariant** (the correctness handle, asserted in tests
and bench-smoke): ``sum_i(decode_s + prefill_s + scatter_s + idle_s)
== settled_s`` — every attributed call's wall re-sums exactly, so a
wrong weighting scheme cannot hide.

Same zero-cost-when-off discipline as the tracer: every engine call
site guards on ``accounting.enabled`` (one attribute read), so the
disabled path builds no lists, takes no locks, reads no clocks —
proven by a bombed-methods test."""
from __future__ import annotations

import threading


class TenantAccounting:
    """Per-instance device-time ledger; disabled until :meth:`start`.

    Methods assume capture is on (call sites guard on ``enabled``).
    ``queued_fn`` — set by the engine to ``scheduler.queued_instances``
    — supplies the waiters for interference attribution; attribution
    itself is mutation-free with respect to the engine."""

    def __init__(self, num_instances: int = 0):
        self.enabled = False
        self.m = num_instances
        self.queued_fn = None        # () -> list of instances with queued work
        self._lock = threading.Lock()
        self._reset()

    def _reset(self) -> None:
        m = self.m
        self.decode_s = [0.0] * m
        self.prefill_s = [0.0] * m
        self.scatter_s = [0.0] * m
        self.idle_s = [0.0] * m
        self.queue_wait_s = [0.0] * m
        self.replay_s = [0.0] * m
        self.replay_tokens = [0] * m
        self.settled_s = 0.0
        self.device_calls = 0
        # interference[w][o] = seconds the grid ran tenant o's work
        # while tenant w had requests queued
        self.interference: list[dict] = [dict() for _ in range(m)]

    # -- lifecycle -----------------------------------------------------------

    def start(self, num_instances: int | None = None) -> None:
        """Begin (or restart) accounting; the ledger resets so a fresh
        window never mixes with a previous one."""
        with self._lock:
            if num_instances is not None:
                self.m = num_instances
            self._reset()
            self.enabled = True

    def stop(self) -> None:
        self.enabled = False

    # -- attribution (call only when ``enabled``) ----------------------------

    def _interfere(self, wall_s: float, shares, total: float) -> None:
        # shares: per-instance occupancy weights for this call
        fn = self.queued_fn
        if fn is None or total <= 0:
            return
        for w in fn():
            acc = self.interference[w]
            for i, s in enumerate(shares):
                if s:
                    acc[i] = acc.get(i, 0.0) + wall_s * s / total

    def note_decode(self, wall_s: float, active_counts, capacity: int) -> None:
        """One settled fused decode call: ``active_counts[i]`` decoding
        slots for instance i, out of ``capacity = M*B`` total."""
        with self._lock:
            self.settled_s += wall_s
            self.device_calls += 1
            per = wall_s / capacity if capacity else 0.0
            b = capacity // self.m if self.m else 0
            for i, a in enumerate(active_counts):
                self.decode_s[i] += per * a
                self.idle_s[i] += per * (b - a)
            self._interfere(wall_s, active_counts, sum(active_counts))

    def note_prefill(self, wall_s: float, lane_instances, lanes: int) -> None:
        """One settled prefill chunk call: ``lane_instances`` lists the
        owning instance of each busy lane (repeats allowed)."""
        with self._lock:
            self.settled_s += wall_s
            self.device_calls += 1
            per = wall_s / lanes if lanes else 0.0
            shares = [0] * self.m
            for inst in lane_instances:
                self.prefill_s[inst] += per
                shares[inst] += 1
            idle = wall_s - per * len(lane_instances)
            if self.m and idle > 0:
                for i in range(self.m):
                    self.idle_s[i] += idle / self.m
            self._interfere(wall_s, shares, len(lane_instances))

    def note_scatter(self, wall_s: float, instance: int) -> None:
        """One prefill→grid slot scatter: serves exactly one request."""
        with self._lock:
            self.settled_s += wall_s
            self.device_calls += 1
            self.scatter_s[instance] += wall_s
            shares = [0] * self.m
            shares[instance] = 1
            self._interfere(wall_s, shares, 1)

    def note_queue_wait(self, instance: int, wait_s: float) -> None:
        with self._lock:
            self.queue_wait_s[instance] += wait_s

    def note_replay(self, counts: dict, wall_s: float, tokens: int) -> None:
        """Replayed (suppressed re-emission, §6.8) tokens this decode
        call, per instance; charged a token-weighted share of the
        call's wall.  A view over decode time — NOT part of
        conservation."""
        with self._lock:
            for i, n in counts.items():
                self.replay_tokens[i] += n
                if tokens:
                    self.replay_s[i] += wall_s * n / tokens

    # -- report --------------------------------------------------------------

    def attributed_s(self) -> float:
        return (sum(self.decode_s) + sum(self.prefill_s)
                + sum(self.scatter_s) + sum(self.idle_s))

    def conservation(self) -> dict:
        """The invariant: attributed time re-sums to settled time."""
        with self._lock:
            attributed = self.attributed_s()
            settled = self.settled_s
        denom = max(settled, 1e-12)
        return {"attributed_s": attributed, "settled_s": settled,
                "rel_err": abs(attributed - settled) / denom}

    def snapshot(self) -> dict:
        with self._lock:
            per_tenant = {
                str(i): {
                    "decode_s": self.decode_s[i],
                    "prefill_s": self.prefill_s[i],
                    "scatter_s": self.scatter_s[i],
                    "idle_s": self.idle_s[i],
                    "device_s": (self.decode_s[i] + self.prefill_s[i]
                                 + self.scatter_s[i]),
                    "queue_wait_s": self.queue_wait_s[i],
                    "replay_s": self.replay_s[i],
                    "replay_tokens": self.replay_tokens[i],
                }
                for i in range(self.m)
            }
            attributed = self.attributed_s()
            settled = self.settled_s
            interference = {
                str(w): {str(o): s for o, s in acc.items()}
                for w, acc in enumerate(self.interference) if acc
            }
        return {
            "enabled": self.enabled,
            "device_calls": self.device_calls,
            "settled_s": settled,
            "attributed_s": attributed,
            "idle_total_s": sum(v["idle_s"] for v in per_tenant.values()),
            "conservation_rel_err": (abs(attributed - settled)
                                     / max(settled, 1e-12)),
            "per_tenant": per_tenant,
            "interference": interference,
        }

    def format_table(self) -> str:
        """Human-readable end-of-run attribution report (serve.py)."""
        snap = self.snapshot()
        lines = ["per-tenant device-time attribution",
                 f"  settled {snap['settled_s']:.3f} s over "
                 f"{snap['device_calls']} device calls, conservation "
                 f"rel err {snap['conservation_rel_err']:.2e}",
                 "  inst   decode_s  prefill_s  scatter_s    idle_s  "
                 "queue_wait_s  replay_s"]
        for i, t in sorted(snap["per_tenant"].items(), key=lambda kv: int(kv[0])):
            lines.append(
                f"  {i:>4}  {t['decode_s']:9.3f}  {t['prefill_s']:9.3f}  "
                f"{t['scatter_s']:9.3f}  {t['idle_s']:8.3f}  "
                f"{t['queue_wait_s']:12.3f}  {t['replay_s']:8.3f}")
        if snap["interference"]:
            lines.append("  head-of-line interference (waiter <- occupant):")
            for w, acc in sorted(snap["interference"].items()):
                causes = ", ".join(f"inst {o}: {s:.3f} s"
                                   for o, s in sorted(acc.items()))
                lines.append(f"    inst {w} waited under  {causes}")
        return "\n".join(lines)
