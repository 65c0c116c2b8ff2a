"""AsyncEngine — the concurrency layer over the synchronous step loop
(port of ``repro.serving.frontend.async_engine``).

The paper's deployment scenario (§2.1) is M fine-tuned instances serving
*different input streams from different clients*; ``MultiModelServer``
is a synchronous ``step()`` loop only one caller can drive.  This module
is the front door: an asyncio wrapper (stdlib only) that owns the step
loop on a background **driver task** and exposes

* ``submit()`` — returns a per-request :class:`TokenStream`, an async
  iterator yielding tokens as each fused engine step lands, terminated
  by the request's :class:`~repro_torch.serving.scheduler.Result`,
* **cancellation** — ``stream.cancel()`` / ``engine.cancel(rid)`` abort
  a request at ANY lifecycle stage (queued / prefilling / decoding); the
  engine frees its queue entry, prefill lane or grid slot so the next
  step refills it from the queues,
* **backpressure** — ``max_queue_depth`` bounds each instance's queue;
  ``submit(wait=True)`` awaits space, ``wait=False`` raises
  :class:`Backpressure` carrying the observed depth (HTTP maps it to
  429),
* **deadline/TTL** — ``submit(ttl_s=...)``: the step loop expires overdue
  requests between steps (terminal ``status="expired"``),
* **graceful drain** — ``drain()`` stops intake and awaits in-flight
  work; ``aclose(drain=False)`` aborts live requests instead.

Concurrency model — single-writer, no locks:

* ALL engine state mutations happen on the step loop: client coroutines
  never touch the engine; ``submit``/``cancel`` enqueue commands which
  the step loop applies strictly BETWEEN steps, in arrival order.
* The blocking device step runs in the event loop's default executor,
  so the loop stays responsive (HTTP accepts, stream reads) while the
  fused program runs — still exactly ONE device call per engine step
  (under multi-step decode, DESIGN.md §6.6, that one call covers up to
  ``decode_steps`` scan steps; the engine unrolls the token block
  host-side, so ``on_token`` still fires per token and streams flush
  up to K tokens per step).
* Token fan-out: the engine's ``on_token`` hook appends to a buffer
  from the executor thread (GIL-atomic list append); after the step
  future resolves, the step loop — back on the loop thread — flushes the
  buffer into each stream's queue and delivers terminal Results.
* Cancellation under multi-step decode keeps its semantics: commands
  apply between steps, so a cancel landing while a K-step block is in
  flight takes effect at the next step boundary — the client keeps the
  partial tokens already unrolled, and the slot frees before the next
  block dispatches.

The step runs on an executor thread.  ``torch.inference_mode`` is a
per-thread state, so the engine's own ``inference_mode`` scopes cover
every device call it makes, and every tensor names its device: nothing
rests on the thread's current device.  The frontend serves on one
device: a server built on a mesh (``tp=``) raises here.

Determinism: with greedy sampling a stream depends only on its own
prompt (exact chunked prefill + independent slots), so N concurrent
clients receive token streams bit-identical to the same requests pushed
through the synchronous ``run_until_drained`` path, regardless of how
client coroutines interleave (tests/test_serving_async.py, no-mesh and
8-device mesh).
"""
from __future__ import annotations

import asyncio
import time
from collections import deque

from repro_torch.serving.engine import MultiModelServer
from repro_torch.serving.resilience.faults import MESH_PERIPHERY
from repro_torch.serving.scheduler import Request, Result


class Backpressure(RuntimeError):
    """An instance's bounded queue is full; carries the depth signal."""

    def __init__(self, instance: int, depth: int, limit: int):
        super().__init__(
            f"instance {instance} queue depth {depth} >= limit {limit}"
        )
        self.instance = instance
        self.depth = depth
        self.limit = limit


class EngineClosed(RuntimeError):
    """submit() after drain()/aclose() began."""


class TokenStream:
    """One request's async token stream.

    ``async for tok in stream`` yields generated token ids as the fused
    engine steps land; iteration ends when the request reaches ANY
    terminal state (complete / cancelled / expired / rejected), after
    which ``await stream.result()`` returns the terminal
    :class:`Result` (full token list, status, error).
    """

    def __init__(self, request_id: int, instance: int, engine: "AsyncEngine"):
        self.request_id = request_id
        self.instance = instance
        self._engine = engine
        self._q: asyncio.Queue = asyncio.Queue()
        self._result: Result | None = None
        self._done = asyncio.Event()
        self._exhausted = False
        # every token delivered to this client, in order — the exact
        # client-visible prefix crash recovery must not re-send: the
        # Supervisor requeues from it (DESIGN.md §6.8)
        self.emitted: list[int] = []

    # -- driver side ---------------------------------------------------------

    def _push_token(self, tok: int) -> None:
        self.emitted.append(tok)
        self._q.put_nowait(tok)

    def _push_terminal(self, res: Result) -> None:
        self._result = res
        self._q.put_nowait(res)      # queued AFTER all tokens: ends iteration
        self._done.set()

    # -- client side ---------------------------------------------------------

    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        if self._exhausted:
            raise StopAsyncIteration
        item = await self._q.get()
        if isinstance(item, Result):
            self._exhausted = True
            raise StopAsyncIteration
        return item

    async def result(self) -> Result:
        """Await the terminal Result (without requiring iteration)."""
        await self._done.wait()
        return self._result

    def done(self) -> bool:
        return self._done.is_set()

    async def cancel(self) -> bool:
        """Abort this request; True if it was still live."""
        return await self._engine.cancel(self.request_id)


class AsyncEngine:
    """Owns a :class:`MultiModelServer`'s step loop on a driver task and
    fans its token flow out to concurrent per-request streams."""

    def __init__(self, server: MultiModelServer, *, max_queue_depth: int = 0):
        if server.mesh is not None:
            raise NotImplementedError(MESH_PERIPHERY)
        self.server = server
        # per-instance queue bound; 0 = unbounded (no backpressure)
        self.max_queue_depth = max_queue_depth
        # ONE bound-method object, kept for the detach identity checks
        # (each `self._on_token` attribute access builds a fresh bound
        # method, so `is` would never match without this)
        self._hook = self._on_token
        server.on_token = self._hook
        self._tok_buf: list[tuple[int, int]] = []
        self._commands: deque = deque()
        self._streams: dict[int, TokenStream] = {}
        self._deadlines: dict[int, float] = {}
        # pending submit commands per instance: counted into the depth
        # signal so racing submits can't overshoot the bound before the
        # driver applies them
        self._pending_submits: dict[int, int] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._wake: asyncio.Event | None = None
        self._space: asyncio.Condition | None = None
        self._driver: asyncio.Task | None = None
        self._closing = False
        # live Request objects by id — what crash recovery requeues
        # (the engine's own bookkeeping dies with the crash)
        self._requests: dict[int, Request] = {}
        # supervised lifecycle (resilience/supervisor.py): when True the
        # Supervisor owns driver death — the step loop leaves streams,
        # commands and request records intact for recovery instead of
        # failing them, and only the Supervisor restarts it
        self.supervised = False
        self._supervisor = None
        # watchdog instrumentation: loop-clock timestamp when the
        # current device step entered the executor (None between steps),
        # and the step's concurrent.futures handle (recovery awaits it —
        # a stalled executor thread cannot be killed, only waited out)
        self._step_started: float | None = None
        self._step_future = None

    # -- lifecycle -----------------------------------------------------------

    def _ensure_started(self) -> None:
        if self._loop is None:
            self._loop = asyncio.get_running_loop()
            self._wake = asyncio.Event()
            self._space = asyncio.Condition()
        # never resurrect a closed/failed driver (its finally sets
        # _closing): submit raises EngineClosed, cancel returns False.
        # Under supervision a dead driver is the Supervisor's to restart
        # — resurrecting it here would race the recovery requeue
        if self._closing:
            return
        if self._driver is None or (self._driver.done()
                                    and not self.supervised):
            self._driver = self._loop.create_task(
                self._drive(), name="engine-driver")

    def _restart_driver(self) -> None:
        """(Supervisor-only) start a fresh driver task after recovery."""
        self._driver = self._loop.create_task(
            self._drive(), name="engine-driver")
        self._wake.set()

    async def __aenter__(self) -> "AsyncEngine":
        self._ensure_started()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose(drain=exc == (None, None, None))

    async def _await_stopped(self) -> None:
        """Wait for the step loop to be truly over.  A driver that died
        on an exception already delivered it to every waiter (terminal
        ``status="error"`` Results, ``EngineClosed`` futures), so drain/
        aclose RETURN instead of re-raising — nobody hangs on a queue no
        driver drains, and nobody gets the failure twice.  Under
        supervision, "over" means the Supervisor stopped (clean drain or
        gave up), not any single driver incarnation's death."""
        if self._supervisor is not None and self._supervisor.stopped is not None:
            await self._supervisor.stopped.wait()
            return
        if self._driver is not None:
            try:
                await self._driver
            except BaseException:
                pass

    async def drain(self) -> None:
        """Stop accepting submissions; wait until every in-flight request
        reached its terminal Result and the step loop exited."""
        self._ensure_started()
        self._closing = True
        self._wake.set()
        await self._await_stopped()

    async def aclose(self, *, drain: bool = True) -> None:
        """Shut the frontend down: graceful (default — in-flight work
        finishes) or immediate (``drain=False`` — live requests are
        cancelled, their streams end with ``status="cancelled"``)."""
        if self._driver is None or (self._driver.done()
                                    and not self.supervised):
            self._closing = True
            if self.server.on_token is self._hook:
                self.server.on_token = None
            await self._await_stopped()
            return
        self._closing = True
        if not drain:
            # routed through the command queue: the step loop applies it
            # between steps, never while the engine is mid-device-call
            self._commands.append(("abort_all",))
        self._wake.set()
        await self._await_stopped()

    # -- client API ----------------------------------------------------------

    def queue_depth(self, instance: int) -> int:
        """The backpressure signal: queued + not-yet-applied submissions
        for this instance (admitted/decoding requests are not queued)."""
        return (self.server.scheduler.depth(instance)
                + self._pending_submits.get(instance, 0))

    async def submit(self, request: Request, *, ttl_s: float | None = None,
                     wait: bool = True) -> TokenStream:
        """Submit a request; returns its :class:`TokenStream`.

        Invalid requests (empty prompt, prompt past the serving context,
        bad instance) do NOT raise: they return a stream that is already
        terminal with ``status="rejected"`` — the same shape every other
        outcome has.  ``ttl_s`` bounds the request's total lifetime;
        overdue requests are expired between steps wherever they are.
        Under a bounded queue (``max_queue_depth``), ``wait=True`` awaits
        space and ``wait=False`` raises :class:`Backpressure`."""
        self._ensure_started()
        if self._closing:
            raise EngineClosed("submit() after drain()/aclose()")
        # client-perceived epoch, taken BEFORE any backpressure parking:
        # TTFT/latency metrics and the TTL deadline both count the wait
        # for queue space and the command-queue delay, not just
        # time-in-engine
        epoch = time.perf_counter()
        deadline = None if ttl_s is None else self._loop.time() + ttl_s
        inst = request.instance
        if self.max_queue_depth and 0 <= inst < self.server.m:
            while self.queue_depth(inst) >= self.max_queue_depth:
                if not wait:
                    raise Backpressure(
                        inst, self.queue_depth(inst), self.max_queue_depth
                    )
                async with self._space:
                    # re-check under the condition lock: the step loop's
                    # notify also takes it, so a wakeup between the
                    # outer check and wait() cannot be lost
                    if self._closing:
                        raise EngineClosed(
                            "engine closed while awaiting queue space")
                    if self.queue_depth(inst) < self.max_queue_depth:
                        continue
                    await self._space.wait()
                if self._closing:
                    raise EngineClosed("engine closed while awaiting queue space")
        fut = self._loop.create_future()
        self._pending_submits[inst] = self._pending_submits.get(inst, 0) + 1
        self._commands.append(("submit", request, epoch, deadline, fut))
        self._wake.set()
        return await fut

    def driver_status(self) -> str:
        """Liveness of the step-loop task (the /healthz signal):
        ``not-started`` / ``running`` / ``recovering`` (died under
        supervision — a restart is coming) / ``stopped`` (clean exit) /
        ``failed`` (died unsupervised — the engine is wedged and the
        HTTP layer serves 503)."""
        if self._driver is None:
            return "not-started"
        if not self._driver.done():
            return "running"
        sup = self._supervisor
        if (self.supervised and sup is not None and sup.stopped is not None
                and not sup.stopped.is_set()):
            return "recovering"
        if self._driver.cancelled():
            return "failed"
        return "failed" if self._driver.exception() is not None else "stopped"

    def in_flight(self) -> int:
        """Requests with live streams (queued + prefilling + decoding)."""
        return len(self._streams)

    async def run_in_step_gap(self, fn):
        """Run ``fn()`` on the step-loop task strictly BETWEEN engine steps
        and return its result — the single-writer-safe way to mutate
        engine state (reset metrics, toggle tracing) from a client
        coroutine.  When no driver is running (never started, drained,
        or dead) the call runs directly: with the step loop stopped
        there is no device step to race."""
        self._ensure_started()
        if self._closing and (self._driver is None or self._driver.done()):
            return fn()
        fut = self._loop.create_future()
        self._commands.append(("call", fn, fut))
        self._wake.set()
        return await fut

    async def reset_metrics(self) -> None:
        """Zero the metrics window (applied between steps)."""
        await self.run_in_step_gap(self.server.reset_metrics)

    async def set_tracing(self, on: bool) -> dict:
        """Toggle step-trace capture on the live engine (applied between
        steps, so no device call is half-traced).  Starting clears the
        ring; stopping returns the capture's aggregate summary."""
        tracer = self.server.tracer
        if on:
            def fn():
                tracer.start()
                return {"tracing": True}
        else:
            def fn():
                summary = tracer.summary()
                tracer.stop()
                return {"tracing": False, "summary": summary}
        return await self.run_in_step_gap(fn)

    async def set_accounting(self, on: bool) -> dict:
        """Toggle per-tenant attribution (§6.9) on the live engine —
        applied between steps so no device call is half-attributed
        (which would break the conservation invariant).  Stopping
        returns the final ledger snapshot."""
        acct = self.server.accounting
        if on:
            def fn():
                acct.start()
                return {"accounting": True}
        else:
            def fn():
                snap = acct.snapshot()
                acct.stop()
                return {"accounting": False, "snapshot": snap}
        return await self.run_in_step_gap(fn)

    async def cancel(self, request_id: int, *, status: str = "cancelled") -> bool:
        """Abort a live request (queued / prefilling / decoding); its
        stream ends with the partial tokens and the given terminal
        status.  False if the request already reached a terminal state."""
        if request_id not in self._streams:
            return False
        self._ensure_started()
        if self._closing and (self._driver is None or self._driver.done()):
            return False
        fut = self._loop.create_future()
        self._commands.append(("cancel", request_id, status, fut))
        self._wake.set()
        return await fut

    # -- driver --------------------------------------------------------------

    def _on_token(self, request_id: int, token: int, finished: bool) -> None:
        # called from the executor thread mid-step; list.append is
        # GIL-atomic and the step loop only reads AFTER the step resolves
        self._tok_buf.append((request_id, token))

    def _finish(self, res: Result) -> None:
        self._deadlines.pop(res.request_id, None)
        self._requests.pop(res.request_id, None)
        stream = self._streams.pop(res.request_id, None)
        if stream is not None:
            stream._push_terminal(res)

    def _fail_pending_commands(self, err: str) -> None:
        """Fail every queued command's future (driver death / supervisor
        give-up): submit/cancel/call waiters get :class:`EngineClosed`
        instead of hanging on a future no driver will ever resolve."""
        while self._commands:
            cmd = self._commands.popleft()
            fut = cmd[-1]
            if asyncio.isfuture(fut) and not fut.done():
                fut.set_exception(EngineClosed(err))
        self._pending_submits.clear()

    def _apply_commands(self) -> None:
        while self._commands:
            cmd = self._commands.popleft()
            if cmd[0] == "submit":
                _, request, epoch, deadline, fut = cmd
                inst = request.instance
                n = self._pending_submits.get(inst, 0) - 1
                if n > 0:
                    self._pending_submits[inst] = n
                else:
                    self._pending_submits.pop(inst, None)
                if fut.cancelled():
                    # the caller gave up (e.g. asyncio.wait_for timeout)
                    # before the command was applied: don't queue a
                    # request nobody holds a stream for
                    continue
                out = self.server.try_submit(request, submit_time=epoch)
                if isinstance(out, Result):          # rejected: born terminal
                    stream = TokenStream(out.request_id, inst, self)
                    stream._push_terminal(out)
                else:
                    stream = TokenStream(out, inst, self)
                    self._streams[out] = stream
                    self._requests[out] = request
                    if deadline is not None:
                        self._deadlines[out] = deadline
                if not fut.cancelled():
                    fut.set_result(stream)
            elif cmd[0] == "cancel":
                _, request_id, status, fut = cmd
                res = self.server.cancel(request_id, status=status)
                if res is not None:
                    self._finish(res)
                if not fut.cancelled():
                    fut.set_result(res is not None)
            elif cmd[0] == "call":
                _, fn, fut = cmd
                if fut.cancelled():
                    continue
                try:
                    out = fn()
                except BaseException as e:   # surfaced to the caller only
                    fut.set_exception(e)
                else:
                    fut.set_result(out)
            elif cmd[0] == "abort_all":
                for rid in list(self._streams):
                    res = self.server.cancel(rid)
                    if res is not None:
                        self._finish(res)

    def _expire(self) -> None:
        now = self._loop.time()
        for rid, deadline in list(self._deadlines.items()):
            if now >= deadline:
                res = self.server.cancel(rid, status="expired")
                if res is not None:
                    res.error = "deadline exceeded"
                    self._finish(res)
                else:
                    self._deadlines.pop(rid, None)

    async def _notify_space(self) -> None:
        async with self._space:
            self._space.notify_all()

    async def _drive(self) -> None:
        loop = self._loop
        try:
            while True:
                self._apply_commands()
                self._expire()
                if not self.server.busy():
                    await self._notify_space()
                    if self._commands:
                        continue
                    if self._closing:
                        return
                    self._wake.clear()
                    # re-check: a command may have arrived between the
                    # busy() check and clearing the wake flag
                    if self._commands or self.server.busy():
                        continue
                    await self._wake.wait()
                    continue
                del self._tok_buf[:]
                # driver-site fault hook: counted once per device step
                # (not per loop iteration — idle wakeups depend on event
                # loop timing and would break schedule determinism) and
                # fired BEFORE dispatch, so a crash here leaves host
                # state consistent for replay
                inj = getattr(self.server, "faults", None)
                if inj is not None and inj.armed:
                    inj.on_call("driver")
                # the ONLY device work in the frontend: one synchronous
                # engine step, off the loop thread.  _step_started feeds
                # the Supervisor's watchdog; _step_future lets recovery
                # wait out a step already in flight (an executor thread
                # cannot be killed, only awaited).  Shielded: cancelling
                # the step loop must leave the step's future pending until
                # its thread is done, or the watchdog's soft recovery
                # would reset the server under a step still running
                self._step_started = loop.time()
                self._step_future = loop.run_in_executor(
                    None, self.server.step)
                try:
                    done = await asyncio.shield(self._step_future)
                finally:
                    self._step_started = None
                for rid, tok in self._tok_buf:
                    stream = self._streams.get(rid)
                    if stream is not None:
                        stream._push_token(tok)
                for res in done:
                    self._finish(res)
                await self._notify_space()
        except BaseException as e:
            if self.supervised:
                # the Supervisor owns driver death: leave streams,
                # request records and queued commands intact — recovery
                # requeues every live request with its emitted prefix
                # and the restarted driver applies the surviving
                # commands
                raise
            # unsupervised: fail loudly but leave no waiter hanging —
            # pending commands and live streams all observe the error,
            # each stream keeping the tokens already delivered
            err = f"engine driver failed: {e!r}"
            self._fail_pending_commands(err)
            for rid in list(self._streams):
                stream = self._streams[rid]
                self._finish(Result(
                    rid, stream.instance, list(stream.emitted),
                    status="error", error=err,
                ))
            raise
        finally:
            if not self.supervised:
                self._closing = True
                # detach the token hook however the step loop exits (drain,
                # aclose, failure): a dead engine's _tok_buf must not
                # keep accumulating tokens from later synchronous
                # serving, and the identity guard never silences a NEWER
                # AsyncEngine attached to the same server.  Supervised
                # drivers keep both — the Supervisor restarts the loop
                # and detaches only on final shutdown/give-up
                if self.server.on_token is self._hook:
                    self.server.on_token = None
            await self._notify_space()
