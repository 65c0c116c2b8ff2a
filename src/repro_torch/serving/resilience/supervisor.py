"""Supervisor — crash/stall recovery for the AsyncEngine driver (port of
``repro.serving.resilience.supervisor``).

The fused serving engine (DESIGN.md §6) runs ONE device call per step;
the async frontend owns that loop on a single driver task.  A fault
anywhere in the step — a poisoned device call, a wedged collective, an
injected crash from :mod:`repro_torch.serving.resilience.faults` — kills the
driver, and without supervision every live stream dies with it.  The
Supervisor turns driver death into a bounded, client-invisible blip:

* **watchdog** — every device step is stamped with its dispatch time
  (``engine._step_started``); a step that overruns ``watchdog_s`` is
  declared stalled, the step loop is cancelled, and recovery proceeds as
  for a crash (with ``server_factory`` the wedged server is abandoned
  wholesale — an executor thread cannot be killed, only orphaned).
* **restart with backoff** — bounded restarts (``max_restarts``), each
  delayed by seeded-jitter exponential backoff so a crash loop cannot
  spin the host.
* **replay-based state reconstruction** — the frontend's records
  (``engine._requests`` + each stream's ``emitted`` prefix) survive the
  crash; recovery resets the serving state to empty and requeues every
  live request under its ORIGINAL id with ``emit_skip`` set to the
  already-delivered prefix length.  Greedy decode regenerates that
  prefix bit-identically (a greedy stream depends only on its own
  prompt — DESIGN.md §6.8 has the exactly-once argument), the engine
  suppresses its re-emission, and the client-visible stream resumes
  exactly where it broke: no token duplicated, none lost.
* **give-up** — past the restart budget every live stream ends with a
  terminal ``status="error"`` Result carrying its partial tokens, and
  pending submitters get :class:`EngineClosed` — nobody hangs.

A hard restart leaves the wedged executor thread its step on the old
server; the new server (from ``server_factory``) shares only read-only
tensors with it, the parameters, and builds its own cache and carries.
On a mesh (a server built with ``tp=``) the Supervisor raises.  Unlike
the reference, a supervised server lets a failed chunk or scatter call
propagate (``MultiModelServer.supervised``): the requests it held have
emitted nothing, so they are replayed like every other live request
instead of failing.

Single-writer discipline is preserved: the Supervisor only touches
engine state while NO driver task is alive (it restarts the step loop
last), so driver and Supervisor never mutate concurrently.
"""
from __future__ import annotations

import asyncio
import random

from repro_torch.serving.resilience.faults import MESH_PERIPHERY
from repro_torch.serving.scheduler import Result


class WatchdogTimeout(RuntimeError):
    """A device step overran the watchdog deadline (injected stall or a
    genuinely wedged device call)."""

    def __init__(self, elapsed_s: float, deadline_s: float):
        super().__init__(
            f"device step ran {elapsed_s:.3f}s against a "
            f"{deadline_s:.3f}s watchdog deadline"
        )
        self.elapsed_s = elapsed_s
        self.deadline_s = deadline_s


class Supervisor:
    """Owns an :class:`~repro_torch.serving.frontend.async_engine.AsyncEngine`
    driver's lifecycle: watchdog, crash detection, backoff restart, and
    replay-based request recovery (module docstring has the model).

    Parameters
    ----------
    engine:         the AsyncEngine to supervise (marked ``supervised``
                    immediately: its driver stops self-terminating on
                    failure and leaves state intact for recovery).
    watchdog_s:     per-device-step deadline; ``None`` disables stall
                    detection (crashes are still recovered).
    max_restarts:   restart budget before giving up.
    backoff_base_s / backoff_cap_s: exponential backoff envelope; the
                    actual delay is ``min(cap, base·2^k)·(0.5+U[0,1))``
                    with a ``seed``-ed RNG, so tests are reproducible.
    max_retries:    per-request requeue budget; ``None`` defers to the
                    engine's BrownoutPolicy (default 3).
    server_factory: zero-arg callable building a replacement
                    ``MultiModelServer`` (same config/params).  Only
                    used for STALL recovery: a wedged executor thread
                    cannot be killed, so the old server is abandoned to
                    it and serving resumes on a fresh one.  Without a
                    factory, stall recovery waits the stalled step out
                    before resetting state on the same server.
    """

    def __init__(self, engine, *, watchdog_s: float | None = None,
                 max_restarts: int = 5, backoff_base_s: float = 0.02,
                 backoff_cap_s: float = 1.0, seed: int = 0,
                 max_retries: int | None = None, server_factory=None):
        if engine.server.mesh is not None:
            raise NotImplementedError(MESH_PERIPHERY)
        self._engine = engine
        self.watchdog_s = watchdog_s
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.max_retries = max_retries
        self.server_factory = server_factory
        self._rng = random.Random(seed)
        # counters surfaced through metrics.snapshot()["resilience"] and
        # the Prometheus exposition
        self.restarts = 0
        self.request_retries = 0
        self.watchdog_timeouts = 0
        self.tokens_replayed = 0
        self.retry_budget_exhausted = 0
        self.last_recovery_s: float | None = None
        self.recoveries: list[dict] = []
        # set()s when the step loop is truly over (clean drain or
        # give-up); None until start() — drain()/aclose() key off it
        self.stopped: asyncio.Event | None = None
        self._task: asyncio.Task | None = None
        engine.supervised = True
        engine._supervisor = self
        engine.server.supervised = True
        engine.server.metrics.resilience_fn = self.snapshot

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Start the step loop (if needed) and the watch loop.  Must run
        inside the event loop (any client coroutine qualifies)."""
        if self._task is not None and not self._task.done():
            return
        self._engine._ensure_started()
        self.stopped = asyncio.Event()
        self._task = self._engine._loop.create_task(
            self._watch(), name="engine-supervisor")

    async def __aenter__(self) -> "Supervisor":
        self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self._engine.aclose(drain=exc == (None, None, None))

    def snapshot(self) -> dict:
        """Resilience counters (the metrics extension hook)."""
        return {
            "driver_restarts": self.restarts,
            "request_retries": self.request_retries,
            "watchdog_timeouts": self.watchdog_timeouts,
            "tokens_replayed": self.tokens_replayed,
            "retry_budget_exhausted": self.retry_budget_exhausted,
            "last_recovery_s": self.last_recovery_s,
            "recoveries": [dict(r) for r in self.recoveries],
        }

    # -- watch loop ----------------------------------------------------------

    async def _watch(self) -> None:
        eng = self._engine
        loop = eng._loop
        poll = (self.watchdog_s / 4) if self.watchdog_s else 0.05
        while True:
            driver = eng._driver
            try:
                # shield: a poll timeout must not cancel the step loop
                await asyncio.wait_for(asyncio.shield(driver), timeout=poll)
            except asyncio.TimeoutError:
                started = eng._step_started
                if (self.watchdog_s is not None and started is not None
                        and loop.time() - started > self.watchdog_s):
                    if not await self._recover_from_stall(
                            loop.time() - started):
                        return
                continue
            except asyncio.CancelledError:
                raise
            except BaseException as e:
                reason = f"crash: {type(e).__name__}: {e}"
                if not await self._recover(reason):
                    return
                continue
            # clean exit: drain()/aclose() finished every in-flight
            # request before the step loop returned
            self._shutdown()
            return

    # -- recovery ------------------------------------------------------------

    async def _recover_from_stall(self, elapsed_s: float) -> bool:
        """Watchdog path: cancel the (live but blocked) driver, then
        either abandon the wedged server (``server_factory``) or wait
        the stalled step out, and recover as for a crash."""
        eng = self._engine
        self.watchdog_timeouts += 1
        timeout = WatchdogTimeout(elapsed_s, self.watchdog_s)
        driver = eng._driver
        driver.cancel()
        try:
            await driver
        except BaseException:
            pass
        # flight-record the WEDGED server now — the factory path below
        # swaps it out before _recover runs (metrics/trace reads are
        # host-side, safe even with the stalled step still in flight)
        flight = getattr(eng.server, "flight", None)
        if flight is not None and flight.enabled:
            flight.dump(f"watchdog: {timeout}", server=eng.server,
                        extra={"restarts": self.restarts,
                               "in_flight": len(eng._streams)})
        if self.server_factory is not None:
            # hard restart: the stalled executor thread keeps the old
            # server; detach its token hook FIRST so late emissions
            # from the orphaned step can't leak into the new buffer
            old = eng.server
            old.on_token = None
            if eng._step_future is not None:
                # nobody awaits the orphaned step: retrieve its outcome
                # when it ends, so a failure there is not reported unread
                eng._step_future.add_done_callback(
                    lambda f: f.cancelled() or f.exception())
            new = self.server_factory()
            # request ids must stay unique across the swap: requeued
            # requests keep their original ids, new submissions must
            # not collide with them
            new._req_counter = max(new._req_counter, old._req_counter)
            new.supervised = True
            new.on_token = eng._hook
            new.metrics.resilience_fn = self.snapshot
            # observability continuity (§6.9): the replacement server
            # keeps the old ledger, flight recorder, and SLO config so
            # tenant accounts and error budgets span the swap
            new.accounting = old.accounting
            new.accounting.queued_fn = new.scheduler.queued_instances
            new.prefill.accounting = old.accounting
            new.metrics.accounting_fn = old.accounting.snapshot
            new.flight = old.flight
            new.metrics.slo = old.metrics.slo
            eng.server = new
            return await self._recover(f"watchdog: {timeout}",
                                       reset_state=False,
                                       flight_dumped=True)
        # soft path: an executor thread cannot be killed — wait the
        # stalled step out, then reset state on the same server
        fut = eng._step_future
        if fut is not None:
            try:
                await asyncio.shield(fut)
            except BaseException:
                pass
        return await self._recover(f"watchdog: {timeout}",
                                   flight_dumped=True)

    async def _recover(self, reason: str, *, reset_state: bool = True,
                       flight_dumped: bool = False) -> bool:
        """Backoff, reset the serving state, requeue every live request
        with its delivered prefix, and restart the step loop.  Returns
        False when the restart budget is exhausted (watch loop exits)."""
        eng = self._engine
        loop = eng._loop
        # flight recorder (§6.9): freeze the pre-reset state — trace
        # tail, metrics/SLO snapshot, queue depths — while the incident
        # is still visible (watchdog paths dumped the wedged server
        # already and say so via ``flight_dumped``)
        flight = getattr(eng.server, "flight", None)
        if not flight_dumped and flight is not None and flight.enabled:
            flight.dump(reason, server=eng.server,
                        extra={"restarts": self.restarts,
                               "in_flight": len(eng._streams)})
        if self.restarts >= self.max_restarts:
            await self._give_up(reason)
            return False
        self.restarts += 1
        delay = min(self.backoff_cap_s,
                    self.backoff_base_s * 2 ** (self.restarts - 1))
        await asyncio.sleep(delay * (0.5 + self._rng.random()))
        t0 = loop.time()
        if reset_state:
            # the frontend's records are the recovery truth; the
            # engine-side live list only feeds the trace/debug log
            eng.server.reset_serving_state()
        del eng._tok_buf[:]
        eng._step_future = None
        budget = self.max_retries
        if budget is None:
            pol = eng.server.policy
            budget = pol.max_retries if pol is not None else 3
        requeued = failed = 0
        for rid in sorted(eng._streams):
            req = eng._requests.get(rid)
            stream = eng._streams[rid]
            if req is None:        # defensive: no record, fail terminally
                eng._finish(Result(
                    rid, stream.instance, list(stream.emitted),
                    status="error",
                    error=f"no request record for recovery ({reason})",
                ))
                failed += 1
                continue
            req.retries += 1
            if req.retries > budget:
                self.retry_budget_exhausted += 1
                eng._finish(Result(
                    rid, stream.instance, list(stream.emitted),
                    prompt_len=len(req.prompt), status="error",
                    error=f"retry budget exhausted after {budget} "
                          f"restarts ({reason})",
                ))
                failed += 1
                continue
            self.request_retries += 1
            self.tokens_replayed += len(stream.emitted)
            eng.server.requeue(req, emitted=list(stream.emitted))
            requeued += 1
        if eng.server.tracer.enabled:
            eng.server.tracer.request_event(-1, "restart", status=reason)
        eng._restart_driver()
        dt = loop.time() - t0
        self.last_recovery_s = dt
        self.recoveries.append({
            "reason": reason, "restart": self.restarts,
            "requeued": requeued, "failed": failed,
            "time_to_recover_s": dt,
        })
        await eng._notify_space()
        return True

    async def _give_up(self, reason: str) -> None:
        """Restart budget exhausted: terminal-fail every live stream
        (keeping its delivered tokens), fail pending submitters, close
        the engine.  Nobody hangs; nobody silently loses tokens."""
        eng = self._engine
        flight = getattr(eng.server, "flight", None)
        if flight is not None and flight.enabled:
            flight.dump(f"give-up: {reason}", server=eng.server,
                        extra={"restarts": self.restarts,
                               "in_flight": len(eng._streams)})
        err = (f"engine driver failed permanently after "
               f"{self.restarts} restarts: {reason}")
        eng._fail_pending_commands(err)
        for rid in sorted(eng._streams):
            stream = eng._streams[rid]
            req = eng._requests.get(rid)
            eng._finish(Result(
                rid, stream.instance, list(stream.emitted),
                prompt_len=len(req.prompt) if req is not None else 0,
                status="error", error=err,
            ))
        eng._closing = True
        if eng.server.on_token is eng._hook:
            eng.server.on_token = None
        self.stopped.set()
        await eng._notify_space()

    def _shutdown(self) -> None:
        """Clean driver exit (drain/aclose done): release waiters."""
        eng = self._engine
        if eng.server.on_token is eng._hook:
            eng.server.on_token = None
        self.stopped.set()
