"""HTTP serving layer over :class:`AsyncEngine` — stdlib asyncio only
(port of ``repro.serving.frontend.http``).

A deliberately small HTTP/1.1 server (``asyncio.start_server``; no
aiohttp/uvicorn — the container bakes no web framework) exposing the
fused (M, B) engine to network clients:

* ``POST /v1/completions`` — OpenAI-style completion over token ids
  (this repro has no tokenizer: ``prompt`` is a list of ints, responses
  carry token ids).  ``model`` routes to the merged instance row — an
  int, a digit string, or a name in the server's model map (default
  ``model-<i>``).  ``"stream": true`` answers with Server-Sent Events:
  one ``data:`` JSON chunk per generated token as each fused engine
  step lands, a final chunk with ``finish_reason``, then ``data:
  [DONE]``.  Client disconnect mid-stream cancels the request — the
  engine frees its queue entry / prefill lane / decode slot on the next
  step.  (A half-close — ``shutdown(SHUT_WR)`` while still reading —
  is indistinguishable from abandonment at this layer and is treated
  as a disconnect too: keep the write side open for the whole stream.)
* ``GET /v1/models`` — the instance-row routing table.
* ``GET /metrics`` — the full ``ServerMetrics.snapshot()`` JSON,
  including per-instance TTFT/ITL p50/p95/p99 and the multi-step
  decode amortization figures (``decode_device_calls``,
  ``tokens_per_device_call`` — DESIGN.md §6.6).  ``Accept: text/plain``
  (or any ``openmetrics`` media type) negotiates Prometheus text
  exposition instead — same counters, scrapable.
* ``POST /metrics/reset`` — zero the metrics window (applied between
  engine steps; cumulative compiled-shape counts survive).
* ``GET /healthz`` — driver-task liveness, per-instance queue depths
  and health states (healthy/degraded/quarantined/probation, §6.8),
  in-flight request count, and supervision counters; answers 503 once
  the step-loop task has died unsupervised (a supervised driver mid-
  recovery reports ``"recovering"`` and stays 200).  Requests routed
  to a quarantined instance answer 503 + ``Retry-After`` — the other
  M−1 instances are unaffected.
* ``GET /debug/trace`` — the step tracer's capture as Chrome-trace
  JSON (load in Perfetto / chrome://tracing); ``POST
  /debug/trace/start`` / ``/debug/trace/stop`` toggle capture on the
  live engine (stop returns the aggregate summary).

Backpressure maps to HTTP: a full bounded queue answers ``429`` with
the queue depth in the body and a ``Retry-After`` hint (the engine-side
``submit(wait=False)`` path); invalid requests (empty prompt, prompt
past the serving context, unknown model) answer ``400``/``404`` from
the SAME validation that governs the Python API (terminal
``status="rejected"`` Results).

One request per connection (``Connection: close``) keeps the parser
trivial; SSE responses are delimited by connection close, so no chunked
framing is needed.
"""
from __future__ import annotations

import asyncio
import json

from repro_torch.serving.frontend.async_engine import (
    AsyncEngine,
    Backpressure,
    EngineClosed,
)
from repro_torch.serving.scheduler import Request

MAX_BODY_BYTES = 8 << 20
MAX_HEADER_LINES = 100


async def _watch_eof(reader) -> None:
    """Resolve only at client EOF, discarding (not buffering) anything
    the client keeps sending — the disconnect signal must not be an
    unbounded memory sink."""
    while await reader.read(4096):
        pass


def default_model_map(num_instances: int) -> dict[str, int]:
    return {f"model-{i}": i for i in range(num_instances)}


# -- tiny HTTP plumbing ------------------------------------------------------


async def _read_request(reader):
    """Parse one HTTP/1.1 request: (method, path, headers, body) or None
    on EOF/garbage."""
    try:
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            return None
        method, path = parts[0].upper(), parts[1]
        headers = {}
        for _ in range(MAX_HEADER_LINES):
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        else:
            return None                   # header flood: drop the request
        n = int(headers.get("content-length", 0))
        if n > MAX_BODY_BYTES:
            return None
        body = await reader.readexactly(n) if n else b""
        return method, path, headers, body
    except (asyncio.IncompleteReadError, ValueError, UnicodeDecodeError):
        return None


def _write_response(writer, status: int, payload, *,
                    ctype: str = "application/json", extra=()) -> None:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              405: "Method Not Allowed", 429: "Too Many Requests",
              500: "Internal Server Error",
              503: "Service Unavailable"}.get(status, "OK")
    body = payload if isinstance(payload, bytes) else (
        json.dumps(payload).encode() + b"\n")
    head = (
        f"HTTP/1.1 {status} {reason}\r\n"
        f"Content-Type: {ctype}\r\n"
        f"Content-Length: {len(body)}\r\n"
        f"Connection: close\r\n"
        + "".join(f"{k}: {v}\r\n" for k, v in extra)
        + "\r\n"
    )
    writer.write(head.encode("latin-1") + body)


def _error(writer, status: int, message: str, extra=(), **fields) -> None:
    _write_response(
        writer, status,
        {"error": {"message": message, "type": "invalid_request_error"
                   if status < 500 else "server_error", **fields}},
        extra=extra,
    )


# -- /v1/completions ---------------------------------------------------------


def _retry_after(engine: AsyncEngine) -> str:
    """Retry-After hint (seconds, integer-formatted) from the engine's
    brownout policy; 1s when no policy is wired."""
    pol = getattr(engine.server, "policy", None)
    secs = pol.retry_after_s if pol is not None else 1.0
    return str(max(1, int(round(secs))))


def _resolve_instance(model, model_map: dict[str, int], m: int):
    if isinstance(model, bool):        # JSON true/false is an int subclass
        return None
    if isinstance(model, int):
        return model if 0 <= model < m else None
    if isinstance(model, str):
        if model in model_map:
            return model_map[model]
        if model.isdigit() and int(model) < m:
            return int(model)
    return None


def _chunk(res_id: int, model, token=None, finish_reason=None) -> bytes:
    payload = {
        "id": f"cmpl-{res_id}",
        "object": "text_completion.chunk",
        "model": model,
        "choices": [{
            "index": 0,
            "token": token,
            "finish_reason": finish_reason,
        }],
    }
    return b"data: " + json.dumps(payload).encode() + b"\n\n"


def _finish_reason(res) -> str:
    # OpenAI vocabulary where it exists ("stop" = EOS, "length" =
    # max_tokens/context cap); our terminal statuses otherwise
    if res.status == "ok":
        return res.finish_reason or "length"
    return res.status


async def _completions(engine: AsyncEngine, model_map, payload,
                       reader, writer) -> None:
    model = payload.get("model", 0)
    instance = _resolve_instance(model, model_map, engine.server.m)
    if instance is None:
        _error(writer, 404, f"unknown model {model!r}; see GET /v1/models")
        return
    prompt = payload.get("prompt")
    if isinstance(prompt, str):
        _error(writer, 400,
               "this server decodes token ids (no tokenizer): send "
               "'prompt' as a list of ints")
        return
    if not isinstance(prompt, list) or not all(
            isinstance(t, int) for t in prompt):
        _error(writer, 400, "'prompt' must be a list of token ids (ints)")
        return
    try:
        max_tokens = int(payload.get("max_tokens", 16))
        ttl_s = payload.get("ttl_s")
        ttl_s = float(ttl_s) if ttl_s is not None else None
    except (TypeError, ValueError):
        _error(writer, 400, "'max_tokens'/'ttl_s' must be numeric")
        return
    try:
        stream = await engine.submit(
            Request(instance=instance, prompt=prompt,
                    max_new_tokens=max_tokens),
            ttl_s=ttl_s, wait=False,
        )
    except Backpressure as e:
        _error(writer, 429, str(e), queue_depth=e.depth,
               queue_limit=e.limit,
               extra=(("Retry-After", _retry_after(engine)),))
        return
    except EngineClosed as e:
        # connection accepted during graceful shutdown (or after a
        # driver failure): answer, don't drop the socket
        _error(writer, 503, str(e))
        return

    # quarantine / brownout rejections are born terminal: answer 503
    # with a Retry-After BEFORE committing to a 200/SSE response, so
    # load balancers see a retryable signal while the other M-1
    # instances keep serving 200s
    if stream.done():
        res = await stream.result()
        if res.status in ("unavailable", "shed"):
            _error(writer, 503, res.error, request_id=res.request_id,
                   reason=res.status,
                   extra=(("Retry-After", _retry_after(engine)),))
            return

    if not payload.get("stream", False):
        # same abandonment policy as the SSE branch: a client that went
        # away must not hold a decode slot to max_tokens — under the
        # bounded-queue/429 regime zombie requests would steal capacity
        # live clients get rejected for
        eof_watch = asyncio.ensure_future(_watch_eof(reader))
        result_t = asyncio.ensure_future(stream.result())
        try:
            await asyncio.wait({eof_watch, result_t},
                               return_when=asyncio.FIRST_COMPLETED)
            if not result_t.done():
                await stream.cancel()
            res = await result_t
        finally:
            eof_watch.cancel()
        if res.status == "cancelled":
            return                       # nobody is listening
        if res.status == "rejected":
            _error(writer, 400, res.error, request_id=res.request_id)
            return
        _write_response(writer, 200, {
            "id": f"cmpl-{res.request_id}",
            "object": "text_completion",
            "model": model,
            "instance": res.instance,
            "choices": [{
                "index": 0,
                "tokens": res.tokens,
                "finish_reason": _finish_reason(res),
            }],
            "usage": {
                "prompt_tokens": res.prompt_len,
                "completion_tokens": len(res.tokens),
            },
            "status": res.status,
            "latency_s": res.latency_s,
        })
        return

    # SSE: headers first, then one data: chunk per token as steps land.
    # A rejected request still streams — exactly one terminal chunk.
    writer.write(
        b"HTTP/1.1 200 OK\r\n"
        b"Content-Type: text/event-stream\r\n"
        b"Cache-Control: no-cache\r\n"
        b"Connection: close\r\n\r\n"
    )
    # watch for client disconnect: a client that closed its socket can't
    # receive more tokens — reading EOF is the portable signal (write
    # errors may lag the close by a full socket buffer).  _watch_eof
    # resolves only at EOF, so pipelined junk can't trigger it (and is
    # discarded, not buffered); a half-close is deliberately treated as
    # abandonment (see module doc)
    eof_watch = asyncio.ensure_future(_watch_eof(reader))
    try:
        it = stream.__aiter__()
        while True:
            # race the next token against client EOF: a disconnect is
            # noticed even while the request is still queued/prefilling
            # (no tokens flowing yet), so zombies never hold capacity
            next_t = asyncio.ensure_future(it.__anext__())
            await asyncio.wait({next_t, eof_watch},
                               return_when=asyncio.FIRST_COMPLETED)
            if eof_watch.done():
                next_t.cancel()
                raise ConnectionResetError("client disconnected")
            try:
                tok = await next_t
            except StopAsyncIteration:
                break
            writer.write(_chunk(stream.request_id, model, token=tok))
            await writer.drain()
        res = await stream.result()
        writer.write(_chunk(res.request_id, model,
                            finish_reason=_finish_reason(res)))
        writer.write(b"data: [DONE]\n\n")
        await writer.drain()
    except (ConnectionResetError, ConnectionAbortedError, BrokenPipeError):
        await stream.cancel()
    finally:
        eof_watch.cancel()


# -- server ------------------------------------------------------------------


async def _handle(engine: AsyncEngine, model_map, reader, writer) -> None:
    try:
        parsed = await _read_request(reader)
        if parsed is not None:
            method, path, _headers, body = parsed
            path = path.split("?", 1)[0]
            if path == "/v1/completions" and method == "POST":
                try:
                    payload = json.loads(body or b"{}")
                    assert isinstance(payload, dict)
                except (json.JSONDecodeError, AssertionError):
                    _error(writer, 400, "body must be a JSON object")
                else:
                    await _completions(engine, model_map, payload,
                                       reader, writer)
            elif path == "/v1/models" and method == "GET":
                # per-instance SLO state (ok/burning/violated) rides the
                # model rows when objectives are configured (§6.9)
                slo_states = engine.server.metrics.slo_states()
                _write_response(writer, 200, {
                    "object": "list",
                    "data": [
                        {"id": name, "object": "model", "instance": idx,
                         "health": engine.server.health.state(idx),
                         "slo": (slo_states[idx] if slo_states is not None
                                 else None)}
                        for name, idx in sorted(model_map.items(),
                                                key=lambda kv: kv[1])
                    ],
                })
            elif path == "/v1/slo" and method == "GET":
                _write_response(writer, 200,
                                engine.server.metrics.slo_report())
            elif path == "/metrics" and method == "GET":
                snap = engine.server.metrics.snapshot()
                accept = _headers.get("accept", "")
                if "text/plain" in accept or "openmetrics" in accept:
                    from repro_torch.serving.obs.prometheus import render
                    _write_response(
                        writer, 200, render(snap).encode(),
                        ctype="text/plain; version=0.0.4; charset=utf-8",
                    )
                else:
                    _write_response(writer, 200, snap)
            elif path == "/metrics/reset" and method == "POST":
                await engine.reset_metrics()
                _write_response(writer, 200, {"status": "reset"})
            elif path == "/healthz" and method == "GET":
                status = engine.driver_status()
                # a failed driver means no step will ever run again:
                # the load balancer must stop routing here.  A
                # "recovering" driver (died under supervision, restart
                # pending) is NOT dead — keep answering 200 so the
                # blip stays client-invisible
                dead = status == "failed"
                sup = engine._supervisor
                _write_response(writer, 503 if dead else 200, {
                    "status": "error" if dead else "ok",
                    "driver": status,
                    "busy": engine.server.busy(),
                    "in_flight": engine.in_flight(),
                    "queue_depths": engine.server.scheduler.depths(),
                    "tracing": engine.server.tracer.enabled,
                    # multi-step decode horizon (DESIGN.md §6.6): scan
                    # steps fused per decode device call
                    "decode_steps": engine.server.decode_steps,
                    # per-instance health lifecycle (§6.8): healthy /
                    # degraded / quarantined / probation
                    "instance_health": engine.server.health.states(),
                    # per-instance SLO state next to health (§6.9);
                    # None when no objectives are configured
                    "slo": engine.server.metrics.slo_states(),
                    "resilience": (sup.snapshot() if sup is not None
                                   else None),
                })
            elif path == "/debug/trace" and method == "GET":
                _write_response(writer, 200,
                                engine.server.tracer.export_chrome())
            elif path == "/debug/trace/start" and method == "POST":
                _write_response(writer, 200,
                                await engine.set_tracing(True))
            elif path == "/debug/trace/stop" and method == "POST":
                _write_response(writer, 200,
                                await engine.set_tracing(False))
            elif path == "/debug/flight" and method == "GET":
                flight = engine.server.flight
                _write_response(writer, 200, {
                    "enabled": flight.enabled,
                    "directory": flight.directory,
                    "count": len(flight),
                    "dumps": flight.latest(),
                })
            elif path in ("/v1/completions", "/v1/models", "/v1/slo",
                          "/metrics", "/metrics/reset", "/healthz",
                          "/debug/trace", "/debug/trace/start",
                          "/debug/trace/stop", "/debug/flight"):
                _error(writer, 405, f"method {method} not allowed on {path}")
            else:
                _error(writer, 404, f"no route for {method} {path}")
        await writer.drain()
    except (ConnectionResetError, ConnectionAbortedError, BrokenPipeError):
        pass
    except Exception as e:        # noqa: BLE001 — a handler bug must
        # answer 500, not silently drop the socket + log an unretrieved
        # task exception
        try:
            _error(writer, 500, f"{type(e).__name__}: {e}")
            await writer.drain()
        except Exception:
            pass
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, ConnectionAbortedError, BrokenPipeError):
            pass


async def start_http_server(engine: AsyncEngine, host: str = "127.0.0.1",
                            port: int = 8000, *,
                            model_map: dict[str, int] | None = None):
    """Serve the engine over HTTP; returns the ``asyncio.Server`` (use
    ``server.sockets[0].getsockname()`` for the bound port, ``async with
    server: await server.serve_forever()`` to run)."""
    mm = dict(model_map) if model_map is not None else default_model_map(
        engine.server.m)

    async def handler(reader, writer):
        await _handle(engine, mm, reader, writer)

    return await asyncio.start_server(handler, host, port)
