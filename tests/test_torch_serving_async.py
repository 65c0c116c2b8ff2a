"""The port's async and HTTP frontends (``device="cpu"``).

Mirrors ``tests/test_serving_async.py`` on one device: concurrent async
clients receive exactly the synchronous engine's greedy streams (and,
for the dense family, the JAX engine's), with one decode dispatch per
engine step; cancellation frees the queue entry, prefill lane or grid
slot at every stage; bounded queues backpressure; TTL expiry and
submit-time rejection end in terminal Results; ``aclose`` without drain
cancels; the HTTP layer streams SSE equal to the sync streams and
cancels on disconnect.  Every asyncio wait is bounded (``_run``) and
HTTP binds 127.0.0.1 on a free port.
"""
import asyncio
import json

import numpy as np
import pytest
import torch

import jax

from repro import api as japi
from repro.configs import registry as jreg
from repro.serving import MultiModelServer as JServer
from repro.serving import Request as JRequest
from repro_torch import api
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import registry
from repro_torch.serving import (
    AsyncEngine,
    Backpressure,
    EngineClosed,
    MultiModelServer,
    Request,
    start_http_server,
)

_PARAMS = {}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _build(arch="tinyllama-1.1b", m=2):
    if (arch, m) not in _PARAMS:
        cfg = registry.get_smoke_config(arch).with_(num_instances=m)
        _PARAMS[arch, m] = (cfg, api.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    return _PARAMS[arch, m]


def _server(cfg, params, **kw):
    kw.setdefault("slots_per_instance", 2)
    kw.setdefault("max_context", 48)
    return MultiModelServer(cfg, params, device="cpu", **kw)


MIX = [(0, [1, 2, 3], 4), (1, [4, 5], 4), (0, [7], 3), (1, [3, 3, 3, 3, 3], 3),
       (0, [2, 2], 3), (1, [9, 8, 7], 4)]


def _reqs(cls=Request):
    return [cls(inst, list(prompt), n) for inst, prompt, n in MIX]


def _run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _stream_all(server, reqs, **engine_kw):
    engine = AsyncEngine(server, **engine_kw)

    async def client(r):
        stream = await engine.submit(r)
        toks = [t async for t in stream]
        return stream.request_id, toks, await stream.result()

    out = await asyncio.gather(*(client(r) for r in reqs))
    await engine.aclose()
    return {rid: (toks, res) for rid, toks, res in out}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "xlstm-1.3b"])
def test_async_streams_bit_identical_to_sync(arch):
    """Async clients get the sync engine's streams (run on the executor
    thread, under the engine's own inference-mode scopes), the streamed
    tokens equal each Result's, and each engine step is one dispatch."""
    cfg, params = _build(arch)
    sync = _server(cfg, params, decode_steps=4)
    for r in _reqs():
        sync.submit(r)
    want = {r.request_id: r.tokens for r in sync.run_until_drained()}

    server = _server(cfg, params, decode_steps=4)
    calls = {"n": 0}
    inner = server._step

    def counting_step(*a, **k):
        calls["n"] += 1
        return inner(*a, **k)

    server._step = counting_step
    got = _run(_stream_all(server, _reqs()))
    assert set(got) == set(want)
    for rid, (toks, res) in got.items():
        assert res.status == "ok" and toks == res.tokens == want[rid]
    assert server.steps > 0 and calls["n"] == server.steps


def test_async_streams_equal_jax_engine():
    jcfg = jreg.get_smoke_config("tinyllama-1.1b").with_(num_instances=2)
    cfg = registry.get_smoke_config("tinyllama-1.1b").with_(num_instances=2)
    jp = japi.init(jcfg, jax.random.PRNGKey(0))
    ref = JServer(jcfg, jp, slots_per_instance=2, max_context=48, decode_steps=8)
    for r in _reqs(JRequest):
        ref.submit(r)
    want = {r.request_id: r.tokens for r in ref.run_until_drained()}
    server = _server(cfg, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu"),
                     decode_steps=8)
    got = _run(_stream_all(server, _reqs()))
    assert {rid: toks for rid, (toks, _res) in got.items()} == want


# -- cancellation at every stage -------------------------------------------------


def test_cancel_mid_decode_frees_slot_and_next_step_refills():
    cfg, params = _build()
    server = _server(cfg, params, slots_per_instance=1)
    vid = server.submit(Request(instance=0, prompt=[1, 2, 3], max_new_tokens=64))
    wid = server.submit(Request(instance=0, prompt=[4, 5], max_new_tokens=3))
    while not server.generated.get(vid):
        server.step()
    assert server.scheduler.depth(0) == 1
    res = server.cancel(vid)
    assert res.status == "cancelled" and res.tokens and not server.slot_busy[0, 0]
    server.step()
    assert server.active[0][0].request_id == wid
    done = {r.request_id: r for r in server.run_until_drained()}
    assert done[wid].status == "ok" and len(done[wid].tokens) == 3
    assert server.cancel(vid) is None


def test_cancel_mid_prefill_frees_lane_and_reserved_slot():
    cfg, params = _build()
    server = _server(cfg, params, slots_per_instance=1, prefill_chunk=2, chunk_budget=1,
                     max_context=64)
    lid = server.submit(Request(instance=0, prompt=list(range(1, 33)), max_new_tokens=2))
    server.step()
    assert server.slot_prefilling[0, 0] and server.prefill.in_flight() == 1
    res = server.cancel(lid)
    assert res.status == "cancelled" and res.tokens == []
    assert server.prefill.in_flight() == 0 and not server.slot_busy[0, 0]
    server.submit(Request(instance=0, prompt=[5, 6, 7], max_new_tokens=3))
    done = server.run_until_drained()
    assert [(r.status, len(r.tokens)) for r in done] == [("ok", 3)]


def test_cancel_mid_queue_and_async_terminal_results():
    cfg, params = _build()
    server = _server(cfg, params, slots_per_instance=1)

    async def main():
        engine = AsyncEngine(server)
        blocker = await engine.submit(Request(instance=0, prompt=[1, 2, 3], max_new_tokens=6))
        queued = await engine.submit(Request(instance=0, prompt=[4, 5], max_new_tokens=4))
        assert await queued.cancel()
        res_q, res_b = await queued.result(), await blocker.result()
        assert not await queued.cancel()
        await engine.aclose()
        return res_q, res_b

    res_q, res_b = _run(main())
    assert res_q.status == "cancelled" and res_q.tokens == []
    assert res_b.status == "ok" and len(res_b.tokens) == 6


# -- backpressure, TTL, rejection, close -----------------------------------------


def test_backpressure_bounded_queue_rejects_and_awaits():
    cfg, params = _build()
    server = _server(cfg, params, slots_per_instance=1)

    async def main():
        engine = AsyncEngine(server, max_queue_depth=1)
        first = await engine.submit(Request(instance=0, prompt=[1, 2], max_new_tokens=24))
        while server.scheduler.depth(0) > 0 or not server.slot_busy[0, 0]:
            await asyncio.sleep(0.005)
        second = await engine.submit(Request(instance=0, prompt=[3, 4], max_new_tokens=2))
        with pytest.raises(Backpressure) as ei:
            await engine.submit(Request(instance=0, prompt=[5], max_new_tokens=2), wait=False)
        assert ei.value.instance == 0 and ei.value.depth >= 1 and ei.value.limit == 1
        other = await engine.submit(Request(instance=1, prompt=[6], max_new_tokens=2),
                                    wait=False)
        third = await engine.submit(Request(instance=0, prompt=[5], max_new_tokens=2))
        results = [await s.result() for s in (first, second, third, other)]
        await engine.aclose()
        return results

    assert [r.status for r in _run(main())] == ["ok"] * 4


def test_ttl_expiry_returns_expired_result():
    cfg, params = _build()
    server = _server(cfg, params, slots_per_instance=1)

    async def main():
        engine = AsyncEngine(server)
        blocker = await engine.submit(Request(instance=0, prompt=[1, 2], max_new_tokens=12))
        doomed = await engine.submit(Request(instance=0, prompt=[3, 4], max_new_tokens=4),
                                     ttl_s=0.0)
        res_d, res_b = await doomed.result(), await blocker.result()
        await engine.aclose()
        return res_d, res_b

    res_d, res_b = _run(main())
    assert res_d.status == "expired" and res_d.tokens == []
    assert res_d.error == "deadline exceeded"
    assert res_b.status == "ok" and len(res_b.tokens) == 12


def test_submit_validation_same_for_sync_raise_and_async_result():
    cfg, params = _build()
    server = _server(cfg, params, max_context=32)
    bad = [(0, [], 4), (0, list(range(1, 200)), 4), (7, [1], 4), (0, [1], 0)]
    sync_errors = []
    for inst, prompt, n in bad:
        with pytest.raises(ValueError) as ei:
            server.submit(Request(inst, list(prompt), n))
        sync_errors.append(str(ei.value))

    async def main():
        engine = AsyncEngine(server)
        out = []
        for inst, prompt, n in bad:
            stream = await engine.submit(Request(inst, list(prompt), n))
            assert [t async for t in stream] == []
            out.append(await stream.result())
        ok = await engine.submit(Request(instance=0, prompt=[1, 2], max_new_tokens=2))
        res = await ok.result()
        await engine.aclose()
        return out, res

    rejected, ok = _run(main())
    assert [r.status for r in rejected] == ["rejected"] * 4
    assert [r.error for r in rejected] == sync_errors
    assert ok.status == "ok" and len(ok.tokens) == 2
    assert server.metrics.snapshot()["instances"][0]["rejected"] == 6


def test_finish_reason_distinguishes_eos_from_length():
    cfg, params = _build()
    ref = _server(cfg, params)
    rid = ref.submit(Request(instance=0, prompt=[1, 2, 3], max_new_tokens=4))
    toks = {r.request_id: r for r in ref.run_until_drained()}[rid].tokens
    server = _server(cfg, params, eos_id=toks[1])
    a = server.submit(Request(instance=0, prompt=[1, 2, 3], max_new_tokens=4))
    res = {r.request_id: r for r in server.run_until_drained()}
    assert res[a].tokens == toks[:2] and res[a].finish_reason == "stop"
    assert ref.metrics.snapshot()["instances"][0]["completed"] == 1


def test_submit_after_close_raises():
    cfg, params = _build()
    server = _server(cfg, params)

    async def main():
        engine = AsyncEngine(server)
        s = await engine.submit(Request(instance=0, prompt=[1], max_new_tokens=2))
        await s.result()
        await engine.drain()
        with pytest.raises(EngineClosed):
            await engine.submit(Request(instance=0, prompt=[2], max_new_tokens=2))

    _run(main())


def test_aclose_without_drain_cancels_live_requests():
    cfg, params = _build()
    server = _server(cfg, params, slots_per_instance=1)

    async def main():
        engine = AsyncEngine(server)
        a = await engine.submit(Request(instance=0, prompt=[1, 2], max_new_tokens=40))
        b = await engine.submit(Request(instance=0, prompt=[3], max_new_tokens=4))
        async for _ in a:
            break
        await engine.aclose(drain=False)
        return await a.result(), await b.result()

    res_a, res_b = _run(main())
    assert res_a.status == "cancelled" and len(res_a.tokens) >= 1
    assert res_b.status == "cancelled" and not server.busy()


def test_token_budget_never_starves_under_cancellation_churn():
    cfg, params = _build(m=3)
    for seed in range(2):
        server = _server(cfg, params, slots_per_instance=1, scheduler="token-budget",
                         max_context=64)
        rng = np.random.default_rng(seed)
        reqs = [Request(i % 3, rng.integers(1, cfg.vocab_size, int(rng.integers(1, 7))).tolist(),
                        int(rng.integers(2, 6))) for i in range(15)]
        ids = [server.submit(r) for r in reqs]
        by_id = dict(zip(ids, reqs))
        cancelled, done, steps = set(), {}, 0
        while server.busy() and steps < 500:
            queued = [r.request_id for q in server.scheduler.queues for r in q]
            if queued and rng.random() < 0.5:
                rid = int(rng.choice(queued))
                assert server.cancel(rid).status == "cancelled"
                cancelled.add(rid)
            decoding = [r.request_id for row in server.active for r in row
                        if r is not None and server.generated.get(r.request_id)]
            if decoding and rng.random() < 0.25:
                rid = int(rng.choice(decoding))
                m = by_id[rid].instance
                b = next(bb for bb in range(server.b) if server.active[m][bb] is not None
                         and server.active[m][bb].request_id == rid)
                assert server.cancel(rid).status == "cancelled"
                assert not server.slot_busy[m, b]
                cancelled.add(rid)
            done.update((r.request_id, r) for r in server.step())
            steps += 1
        assert not server.busy()
        survivors = [rid for rid in ids if rid not in cancelled]
        assert set(done) == set(survivors)
        assert all(done[rid].status == "ok"
                   and len(done[rid].tokens) == by_id[rid].max_new_tokens for rid in survivors)


# -- HTTP ------------------------------------------------------------------------------


async def _http(port, method, path, payload=None, headers=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = b"" if payload is None else json.dumps(payload).encode()
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                 f"Content-Length: {len(body)}\r\n{extra}\r\n".encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, rest = raw.partition(b"\r\n\r\n")
    return head.decode("latin-1"), rest


def _sse_tokens(rest: bytes):
    events = [json.loads(line[len(b"data: "):]) for line in rest.split(b"\n\n")
              if line.startswith(b"data: ") and line != b"data: [DONE]"]
    toks = [e["choices"][0]["token"] for e in events if e["choices"][0]["token"] is not None]
    return toks, events[-1]["choices"][0]["finish_reason"]


def test_http_completions_sse_matches_sync_and_metrics():
    """Two concurrent SSE completions equal their sync streams; the
    non-stream body carries the same tokens; bad requests map to HTTP
    codes; /metrics (JSON and Prometheus text) and /healthz answer."""
    cfg, params = _build()
    sync = _server(cfg, params)
    ids = [sync.submit(Request(i, [1 + i, 2, 3], 4)) for i in range(2)]
    got_sync = {r.request_id: r.tokens for r in sync.run_until_drained()}
    want = [got_sync[i] for i in ids]
    server = _server(cfg, params)

    async def main():
        engine = AsyncEngine(server)
        http = await start_http_server(engine, "127.0.0.1", 0)
        port = http.sockets[0].getsockname()[1]
        sse = await asyncio.gather(*(_http(port, "POST", "/v1/completions", {
            "model": f"model-{i}", "prompt": [1 + i, 2, 3], "max_tokens": 4,
            "stream": True}) for i in range(2)))
        _, body = await _http(port, "POST", "/v1/completions",
                              {"model": 0, "prompt": [1, 2, 3], "max_tokens": 4})
        errs = [(await _http(port, "POST", "/v1/completions", p))[0] for p in (
            {"model": "nope", "prompt": [1]}, {"model": 0, "prompt": []},
            {"model": 0, "prompt": "text"})]
        mh, mb = await _http(port, "GET", "/metrics")
        ph, pb = await _http(port, "GET", "/metrics", headers={"Accept": "text/plain"})
        hh, _ = await _http(port, "GET", "/healthz")
        _, lb = await _http(port, "GET", "/v1/models")
        http.close()
        await http.wait_closed()
        await engine.aclose()
        return sse, json.loads(body), errs, (mh, json.loads(mb)), (ph, pb), hh, json.loads(lb)

    sse, payload, errs, (mh, snap), (ph, pb), hh, models = _run(main())
    for (head, rest), toks in zip(sse, want):
        assert head.startswith("HTTP/1.1 200") and "text/event-stream" in head
        assert _sse_tokens(rest) == (toks, "length")
        assert rest.rstrip().endswith(b"data: [DONE]")
    assert payload["choices"][0]["tokens"] == want[0]
    assert [e.split()[1] for e in errs] == ["404", "400", "400"]
    assert mh.startswith("HTTP/1.1 200") and snap["generated_tokens"] == 12
    assert set(snap["ttft_ms"]) == {"p50", "p95", "p99"}
    assert "text/plain; version=0.0.4" in ph
    assert all(l.startswith("#") or " " in l for l in pb.decode().strip().split("\n"))
    assert hh.startswith("HTTP/1.1 200")
    assert [m["id"] for m in models["data"]] == ["model-0", "model-1"]


def test_http_client_disconnect_cancels_request():
    cfg, params = _build()
    server = _server(cfg, params, slots_per_instance=1)

    async def main():
        engine = AsyncEngine(server)
        http = await start_http_server(engine, "127.0.0.1", 0)
        port = http.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        body = json.dumps({"model": 0, "prompt": [1, 2], "max_tokens": 500,
                           "stream": True}).encode()
        writer.write(f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                     f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        await writer.drain()
        buf = b""
        while b"\n\n" not in buf.partition(b"\r\n\r\n")[2]:
            chunk = await reader.read(4096)
            assert chunk
            buf += chunk
        writer.close()
        await writer.wait_closed()
        for _ in range(200):
            if not server.busy():
                break
            await asyncio.sleep(0.02)
        assert not server.busy()
        after = await engine.submit(Request(instance=0, prompt=[6], max_new_tokens=2))
        res = await after.result()
        http.close()
        await http.wait_closed()
        await engine.aclose()
        return res

    res = _run(main())
    assert res.status == "ok" and len(res.tokens) == 2
    assert server.metrics.snapshot()["cancelled"] == 1


def test_http_nonstream_disconnect_cancels_request():
    cfg, params = _build()
    server = _server(cfg, params, slots_per_instance=1)

    async def main():
        engine = AsyncEngine(server)
        http = await start_http_server(engine, "127.0.0.1", 0)
        port = http.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        body = json.dumps({"model": 0, "prompt": [1, 2], "max_tokens": 500}).encode()
        writer.write(f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                     f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        await writer.drain()
        for _ in range(200):
            if server.metrics.snapshot()["generated_tokens"] > 0:
                break
            await asyncio.sleep(0.02)
        writer.close()
        await writer.wait_closed()
        for _ in range(200):
            if not server.busy():
                break
            await asyncio.sleep(0.02)
        assert not server.busy()
        http.close()
        await http.wait_closed()
        await engine.aclose()

    _run(main())
    snap = server.metrics.snapshot()
    assert snap["cancelled"] == 1 and snap["generated_tokens"] < 500
