"""The port's observability layer (``device="cpu"``) against the reference's.

Step tracing, Prometheus exposition, SLO histograms, tenant accounting
and the flight recorder of ``repro_torch.serving`` mirror
``tests/test_serving_obs.py`` on one device.  Where both packages run
the port is held against the JAX package: equal ``LogHistogram``
percentiles and ``frac_le`` on the same samples, equal SLO evaluations,
the same Prometheus text from both renderers for one snapshot, equal
tracer summaries on the same synthetic events, and the port's snapshot
keys a superset of the reference engine's on the same workload.  Off
means free: the disabled tracer, ledger and recorder run no code.
"""
import asyncio
import json
import math
import os
import random
import re

import pytest
import torch

import jax

from repro import api as japi
from repro.configs import registry as jreg
from repro.serving import MultiModelServer as JServer
from repro.serving import Request as JRequest
from repro.serving.obs import LogHistogram as JHist
from repro.serving.obs import Tracer as JTracer
from repro.serving.obs import evaluate_availability as j_availability
from repro.serving.obs import evaluate_objective as j_objective
from repro.serving.obs import render_prometheus as j_render
from repro_torch import api
from repro_torch.configs import registry
from repro_torch.serving import (
    AsyncEngine,
    FaultInjector,
    FaultSpec,
    FlightRecorder,
    MultiModelServer,
    Request,
    SLOConfig,
    Supervisor,
    start_http_server,
)
from repro_torch.serving.obs import (
    LogHistogram,
    Tracer,
    evaluate_availability,
    evaluate_objective,
    render_prometheus,
    worst_state,
)
from repro_torch.serving.obs.prometheus import escape_label
from repro_torch.serving.obs.slo import HIST_GROWTH

ARCH = "tinyllama-1.1b"
_PARAMS = {}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _build(arch=ARCH, m=2):
    if (arch, m) not in _PARAMS:
        cfg = registry.get_smoke_config(arch).with_(num_instances=m)
        _PARAMS[arch, m] = (cfg, api.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    return _PARAMS[arch, m]


def _server(cfg, params, **kw):
    kw.setdefault("slots_per_instance", 2)
    kw.setdefault("max_context", 48)
    kw.setdefault("prefill_chunk", 4)
    return MultiModelServer(cfg, params, device="cpu", **kw)


def _reqs(cls=Request):
    return [cls(instance=0, prompt=[1, 2, 3], max_new_tokens=4),
            cls(instance=1, prompt=[4, 5], max_new_tokens=4),
            cls(instance=0, prompt=[7], max_new_tokens=3),
            cls(instance=1, prompt=[3, 3, 3, 3, 3], max_new_tokens=3)]


def _drained(**kw):
    cfg, params = _build()
    server = _server(cfg, params, **kw)
    for r in _reqs():
        server.submit(r)
    return server, server.run_until_drained()


def _run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# -- tracing: free when off, invisible when on ----------------------------------


def test_tracing_off_runs_no_tracer_code(monkeypatch):
    cfg, params = _build()
    server = _server(cfg, params)

    def boom(*a, **k):
        raise AssertionError("tracer code ran while capture was off")

    for name in ("device_call", "request_event", "_append"):
        monkeypatch.setattr(server.tracer, name, boom)
    ids = [server.submit(r) for r in _reqs()]
    server.cancel(server.submit(Request(instance=0, prompt=[9, 9], max_new_tokens=2)))
    results = server.run_until_drained()
    assert {r.request_id for r in results} == set(ids)
    assert all(r.status == "ok" for r in results)
    assert len(server.tracer) == 0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "xlstm-1.3b"])
def test_traced_greedy_identical_to_untraced(arch):
    cfg, params = _build(arch)
    server = _server(cfg, params)

    def drain():
        ids = [server.submit(r) for r in _reqs()]
        res = {r.request_id: r.tokens for r in server.run_until_drained()}
        return [res[i] for i in ids]

    want = drain()
    server.tracer.start()
    got = drain()
    server.tracer.stop()
    assert got == want and len(server.tracer) > 0


def test_traced_async_streams_identical_to_untraced_sync():
    _, want = _drained()
    want = sorted(r.tokens for r in want)
    cfg, params = _build()
    server = _server(cfg, params)

    async def main():
        engine = AsyncEngine(server)
        await engine.set_tracing(True)

        async def client(r):
            s = await engine.submit(r)
            toks = [t async for t in s]
            assert (await s.result()).tokens == toks
            return toks

        out = await asyncio.gather(*(client(r) for r in _reqs()))
        stopped = await engine.set_tracing(False)
        await engine.aclose()
        return out, stopped

    got, stopped = _run(main())
    assert sorted(got) == want
    assert stopped["tracing"] is False and stopped["summary"]["decode_steps"] > 0


def test_export_chrome_schema_and_json_roundtrip():
    cfg, params = _build()
    server = _server(cfg, params)
    server.tracer.start()
    for r in _reqs():
        server.submit(r)
    server.run_until_drained()
    server.tracer.stop()
    trace = json.loads(json.dumps(server.tracer.export_chrome()))
    assert trace["displayTimeUnit"] == "ms" and trace["otherData"]["dropped_events"] == 0
    events = trace["traceEvents"]
    device = [e for e in events if e["ph"] == "X" and e["pid"] == 0]
    spans = [e for e in events if e["ph"] == "X" and e["pid"] == 1]
    assert {e["name"] for e in device} == {"decode", "prefill_chunk", "scatter"}
    for e in device:
        assert e["ts"] >= 0 and e["dur"] >= 0
        for k in ("step", "dispatch_ms", "settled_ms", "gap_ms", "active_slots",
                  "slot_capacity", "occupancy"):
            assert k in e["args"], (e["name"], k)
    assert all(e["args"]["slot_capacity"] == server.m * server.b
               for e in device if e["name"] == "decode")
    assert len({e["tid"] for e in spans}) == len(_reqs())
    assert {e["name"] for e in events if e["ph"] == "i"} == {"finish:ok"}


def test_tracer_ring_bounds_memory_and_counts_drops():
    tr = Tracer(capacity=2, clock=lambda: 0.0)
    tr.start()
    for i in range(5):
        tr.device_call("decode", 0.0, 0.0, 0.0, step=i)
    assert len(tr) == 2 and tr.dropped == 3
    assert tr.export_chrome()["otherData"]["dropped_events"] == 3
    tr.start()
    assert len(tr) == 0 and tr.dropped == 0


def _synthetic(tr):
    times = iter([0.0, 1.0, 2.0, 3.0, 4.0, 5.0])
    tr.clock = lambda: next(times)
    tr.start()
    tr.device_call("decode", 1.00, 1.01, 1.05, step=0, active=2, capacity=4)
    tr.device_call("decode", 1.10, 1.11, 1.15, step=1, active=4, capacity=4,
                   decode_steps=4, tokens=9, pending=2)
    tr.device_call("prefill_chunk", 1.20, 1.21, 1.25, step=2, lanes_busy=1, lanes=4,
                   valid_frac=0.5, tokens=8)
    tr.device_call("scatter", 1.30, 1.31, 1.35, step=2)
    for stage in ("submit", "admit", "prefill_done"):
        tr.request_event(7, stage, instance=1)
    tr.request_event(7, "finish", instance=1, status="ok")
    return tr


def test_summary_and_chrome_equal_reference():
    """The same synthetic events give the reference's summary and Chrome
    trace, and the summary's aggregates are the expected ones."""
    mine, ref = _synthetic(Tracer()), _synthetic(JTracer())
    s = mine.summary()
    assert s == ref.summary()
    assert mine.export_chrome() == ref.export_chrome()
    assert s["device_calls"] == 4 and s["decode_steps"] == 2
    assert s["dispatch_overhead_ms"]["p95"] == pytest.approx(50.0)
    assert s["mean_grid_occupancy"] == pytest.approx(0.75)
    assert s["mean_prefill_lane_occupancy"] == pytest.approx(0.25)
    assert s["mean_chunk_validity"] == pytest.approx(0.5)


def test_request_spans_from_synthetic_lifecycle():
    times = iter([0.0, 1.0, 2.0, 3.0, 4.0])
    tr = Tracer(clock=lambda: next(times))
    tr.start()
    for stage in ("submit", "admit", "prefill_done"):
        tr.request_event(7, stage, instance=1)
    tr.request_event(7, "finish", instance=1, status="ok")
    ev = tr.export_chrome()["traceEvents"]
    spans = {e["name"]: e for e in ev if e["ph"] == "X"}
    assert set(spans) == {"queued", "prefill", "decode"}
    assert spans["queued"]["ts"] == pytest.approx(1e6)
    assert spans["decode"]["dur"] == pytest.approx(1e6)


# -- Prometheus -------------------------------------------------------------------

_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*)\})?'
    r' (NaN|[+-]Inf|[+-]?[0-9.eE+-]+)$')


def test_prometheus_exposition_parses_line_by_line():
    server, _ = _drained()
    text = render_prometheus(server.metrics.snapshot())
    typed, samples = {}, {}
    for line in text.strip().split("\n"):
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split(" ", 3)
            assert typ in ("counter", "gauge", "summary", "histogram"), line
            typed[name] = typ
            continue
        m = _SAMPLE.match(line)
        assert m, f"unparseable sample line: {line!r}"
        samples.setdefault(m.group(1), []).append(m.group(3))
    expect = set()
    for name, typ in typed.items():
        expect |= ({f"{name}_bucket", f"{name}_sum", f"{name}_count"}
                   if typ == "histogram" else {name})
    assert set(samples) == expect
    assert samples["repro_generated_tokens_total"] == [str(sum(r.max_new_tokens
                                                               for r in _reqs()))]
    assert int(samples["repro_device_calls_total"][0]) > 0
    assert samples["repro_prefill_compiled_shapes"] == ["1"]
    assert len(samples["repro_instance_completed_total"]) == server.m
    assert typed["repro_instance_ttft_seconds"] == "histogram"


def test_prometheus_text_equals_reference_renderer():
    """One snapshot (the port's, after a crash-free and a shed-free run
    with SLOs and accounting on) renders to the same text in both
    packages."""
    server, _ = _drained(slo=SLOConfig(ttft_ms=500.0, itl_ms=50.0))
    snap = json.loads(json.dumps(server.metrics.snapshot()))
    assert render_prometheus(snap) == j_render(snap)
    labels = {"host": 'a"b'}
    assert render_prometheus(snap, extra_labels=labels) == j_render(snap, extra_labels=labels)


def test_prometheus_histogram_le_buckets_are_valid():
    server, _ = _drained()
    text = render_prometheus(server.metrics.snapshot())
    pat = re.compile(r'^repro_instance_ttft_seconds_bucket\{instance="(\d+)",le="([^"]+)"\} (\d+)$')
    buckets, counts = {}, {}
    for line in text.strip().split("\n"):
        m = pat.match(line)
        if m:
            buckets.setdefault(int(m.group(1)), []).append((m.group(2), int(m.group(3))))
        m = re.match(r'^repro_instance_ttft_seconds_count\{instance="(\d+)"\} (\S+)$', line)
        if m:
            counts[int(m.group(1))] = float(m.group(2))
    assert set(buckets) == set(range(server.m))
    for i, rows in buckets.items():
        les = [math.inf if le == "+Inf" else float(le) for le, _ in rows]
        cums = [c for _, c in rows]
        assert les == sorted(les) and les[-1] == math.inf
        assert cums == sorted(cums) and cums[-1] == counts[i] > 0


def test_prometheus_label_escaping_roundtrips():
    assert escape_label('a\\b"c\nd') == 'a\\\\b\\"c\\nd'
    server, _ = _drained()
    nasty = {"path": 'a\\b"c\nd', "plain": "ok"}
    text = render_prometheus(server.metrics.snapshot(), extra_labels=nasty)
    line = next(l for l in text.split("\n") if l.startswith("repro_generated_tokens_total{"))
    labels = dict(re.findall(r'([a-zA-Z_]+)="((?:[^"\\]|\\.)*)"', _SAMPLE.match(line).group(2)))
    unescape = lambda s: s.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")
    assert unescape(labels["path"]) == nasty["path"] and labels["plain"] == "ok"


# -- snapshot keys and counters -----------------------------------------------------


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("ttft_hist", "itl_hist"):
            out |= _keys(v, prefix + k + ".")
    return out


def test_snapshot_keys_superset_of_reference():
    """The same workload on both engines: every key of the reference's
    snapshot (top level, per instance, resilience, health, slo) is in
    the port's."""
    jcfg = jreg.get_smoke_config(ARCH).with_(num_instances=2)
    kw = dict(slots_per_instance=2, max_context=48, prefill_chunk=4,
              slo=None)
    ref = JServer(jcfg, japi.init(jcfg, jax.random.PRNGKey(0)), **kw)
    for r in _reqs(JRequest):
        ref.submit(r)
    ref.run_until_drained()
    server, _ = _drained()
    want, got = ref.metrics.snapshot(), server.metrics.snapshot()
    assert _keys(want) <= _keys(got), _keys(want) - _keys(got)
    assert _keys(want["instances"][0]) <= _keys(got["instances"][0])
    assert set(got) - set(want) == {"decode_ms_per_step"}


def test_snapshot_device_call_and_compiled_shape_counters():
    server, results = _drained()
    snap = server.metrics.snapshot()
    assert snap["scatter_calls"] == len(results)
    assert snap["device_calls"] == (snap["decode_device_calls"] + snap["prefill_batches"]
                                    + snap["scatter_calls"]) > 0
    assert snap["prefill_compiled_shapes"] == 1
    server.reset_metrics()
    snap2 = server.metrics.snapshot()
    assert snap2["generated_tokens"] == snap2["device_calls"] == 0
    assert snap2["prefill_compiled_shapes"] == 1


# -- HTTP surface -------------------------------------------------------------------


async def _req_http(port, method, path, headers=None, payload=None):
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
    head = head.decode("latin-1")
    ctype = next((l.split(":", 1)[1].strip() for l in head.split("\r\n")
                  if l.lower().startswith("content-type")), "")
    return int(head.split()[1]), ctype, rest


def test_http_observability_routes():
    cfg, params = _build()
    server = _server(cfg, params)

    async def main():
        async with AsyncEngine(server) as engine:
            http = await start_http_server(engine, "127.0.0.1", 0)
            port = http.sockets[0].getsockname()[1]
            st, _, body = await _req_http(port, "GET", "/healthz")
            h = json.loads(body)
            assert st == 200 and h["driver"] == "running" and h["queue_depths"] == [0, 0]
            st, _, body = await _req_http(port, "POST", "/debug/trace/start")
            assert st == 200 and json.loads(body) == {"tracing": True}
            st, _, body = await _req_http(port, "POST", "/v1/completions", payload={
                "model": 0, "prompt": [1, 2, 3], "max_tokens": 4})
            assert st == 200 and len(json.loads(body)["choices"][0]["tokens"]) == 4
            st, ct, body = await _req_http(port, "GET", "/debug/trace")
            assert st == 200 and ct == "application/json"
            assert any(e.get("name") == "decode" for e in json.loads(body)["traceEvents"])
            st, _, body = await _req_http(port, "POST", "/debug/trace/stop")
            assert json.loads(body)["summary"]["decode_steps"] >= 1
            st, ct, body = await _req_http(port, "GET", "/metrics",
                                           headers={"Accept": "text/plain"})
            assert ct == "text/plain; version=0.0.4; charset=utf-8"
            assert b"# TYPE repro_generated_tokens_total counter" in body
            st, ct, body = await _req_http(port, "GET", "/metrics")
            assert ct == "application/json" and json.loads(body)["generated_tokens"] == 4
            st, _, _ = await _req_http(port, "POST", "/metrics/reset")
            _, _, body = await _req_http(port, "GET", "/metrics")
            assert st == 200 and json.loads(body)["generated_tokens"] == 0
            st, _, body = await _req_http(port, "GET", "/v1/slo")
            assert json.loads(body) == {"configured": False}
            st, _, body = await _req_http(port, "GET", "/debug/flight")
            fl = json.loads(body)
            assert fl["enabled"] is False and fl["dumps"] == []
            for method, path in (("GET", "/metrics/reset"), ("POST", "/debug/trace"),
                                 ("POST", "/healthz"), ("POST", "/debug/flight")):
                assert (await _req_http(port, method, path))[0] == 405, (method, path)
            http.close()
            await http.wait_closed()

    _run(main())


def test_healthz_503_when_driver_dies():
    cfg, params = _build()
    server = _server(cfg, params)

    async def main():
        engine = AsyncEngine(server)
        http = await start_http_server(engine, "127.0.0.1", 0)
        port = http.sockets[0].getsockname()[1]

        def explode():
            raise RuntimeError("injected step failure")

        server.step = explode
        stream = await engine.submit(Request(instance=0, prompt=[1, 2], max_new_tokens=2))
        res = await stream.result()
        assert res.status == "error" and "driver failed" in res.error
        st, _, body = await _req_http(port, "GET", "/healthz")
        h = json.loads(body)
        assert st == 503 and h["driver"] == "failed"
        http.close()
        await http.wait_closed()
        await engine.aclose()

    _run(main())


def test_run_in_step_gap_without_running_driver():
    cfg, params = _build()
    server = _server(cfg, params)

    async def main():
        engine = AsyncEngine(server)
        on = await engine.set_tracing(True)
        off = await engine.set_tracing(False)
        acct = await engine.set_accounting(True)
        await engine.reset_metrics()
        await engine.aclose()
        return on, off, acct

    on, off, acct = _run(main())
    assert on == {"tracing": True} and off["tracing"] is False
    assert acct == {"accounting": True}


# -- histograms and SLOs: the reference's numbers --------------------------------


def test_loghistogram_equals_reference():
    rng = random.Random(0)
    vals = [rng.uniform(1e-5, 3.0) for _ in range(3000)] + [500.0, 1e-7]
    mine, ref = LogHistogram(), JHist()
    for v in vals:
        mine.record(v)
        ref.record(v)
    assert mine.counts == ref.counts and mine.sum == ref.sum
    assert mine.percentiles() == ref.percentiles()
    for q in (0.01, 0.5, 0.9, 0.95, 0.99, 0.999):
        assert mine.percentile(q) == ref.percentile(q)
    for t in (1e-4, 0.01, 0.2, 1.0, 2.5, 1e3):
        assert mine.frac_le(t) == ref.frac_le(t)
    assert list(mine.buckets()) == list(ref.buckets())
    assert mine.snapshot() == ref.snapshot()


def test_loghistogram_percentile_error_bound_and_merge():
    rng = random.Random(0)
    vals = [rng.uniform(1e-3, 2.0) for _ in range(5000)]
    h = LogHistogram()
    for v in vals:
        h.record(v)
    s = sorted(vals)
    for q in (0.5, 0.95, 0.99):
        exact = s[max(0, math.ceil(q * len(s)) - 1)]
        assert exact <= h.percentile(q) <= exact * HIST_GROWTH * 1.0001
    a, b = LogHistogram(), LogHistogram()
    for v in vals[:2000]:
        a.record(v)
    for v in vals[2000:]:
        b.record(v)
    a.merge(b)
    assert a.counts == h.counts and a.percentile(0.99) == h.percentile(0.99)


def test_loghistogram_inf_bucket_and_frac_le():
    h = LogHistogram()
    h.record(1e-6)
    h.record(500.0)
    assert h.counts[0] == 1 and h.counts[-1] == 1
    les, cums = zip(*h.buckets())
    assert les[-1] == math.inf and cums[-1] == 2
    assert h.frac_le(1.0) == 0.5 and h.frac_le(1e3) == 0.5
    assert h.percentile(0.99) == LogHistogram.les[-1]
    assert LogHistogram().percentiles() is None


@pytest.mark.parametrize("case", ["ok", "burning", "violated", "empty"])
def test_slo_states_equal_reference(case):
    """The same samples give the reference's objective evaluation (state,
    bad fraction, burn rate, budget), and the states are the expected
    ones."""
    cum, recent = {"ok": ([0.010] * 1000, [0.010] * 50),
                   "burning": ([0.010] * 1000, [0.9] * 10 + [0.010] * 90),
                   "violated": ([0.010] * 90 + [0.9] * 10, [0.010] * 50),
                   "empty": ([], [])}[case]
    mine, ref = LogHistogram(), JHist()
    for v in cum:
        mine.record(v)
        ref.record(v)
    got = evaluate_objective(mine, recent, 200.0, target=0.99)
    assert got == j_objective(ref, recent, 200.0, target=0.99)
    assert got["state"] == ("ok" if case == "empty" else case)
    for completed, failed in ((99, 1), (50, 50), (0, 0)):
        assert evaluate_availability(completed, failed, 0.99) == \
            j_availability(completed, failed, 0.99)
    assert worst_state(["ok", "burning"]) == "burning"


# -- tenant accounting and the flight recorder ---------------------------------------


def test_accounting_and_flight_off_run_no_code(monkeypatch):
    cfg, params = _build()
    server = _server(cfg, params)

    def boom(*a, **k):
        raise AssertionError("accounting/flight code ran while disabled")

    for name in ("note_decode", "note_prefill", "note_scatter", "note_queue_wait",
                 "note_replay", "_interfere", "snapshot", "conservation"):
        monkeypatch.setattr(server.accounting, name, boom)
    monkeypatch.setattr(server.flight, "dump", boom)
    ids = [server.submit(r) for r in _reqs()]
    results = server.run_until_drained()
    assert {r.request_id for r in results} == set(ids)
    assert server.accounting.enabled is False and len(server.flight) == 0
    assert server.health.on_quarantine is None


def test_accounted_streams_bit_identical_and_conserved():
    """Accounting, tracing and SLOs on, chunks of 4 and K=8: the streams
    are the plain run's and the ledger conserves below 1e-6."""
    cfg, params = _build()

    def drain(**kw):
        server = _server(cfg, params, decode_steps=8, **kw)
        if kw:
            server.accounting.start()
            server.tracer.start()
        ids = [server.submit(r) for r in _reqs()]
        res = {r.request_id: r.tokens for r in server.run_until_drained()}
        return server, [res[i] for i in ids]

    _, want = drain()
    server, got = drain(slo=SLOConfig(ttft_ms=200.0, itl_ms=100.0))
    assert got == want
    cons = server.accounting.conservation()
    assert cons["settled_s"] > 0 and cons["rel_err"] < 1e-6, cons
    snap = server.metrics.snapshot()
    acct = snap["accounting"]
    assert acct["enabled"] is True and set(acct["per_tenant"]) == {"0", "1"}
    assert all(t["decode_s"] > 0 and t["prefill_s"] > 0 for t in acct["per_tenant"].values())
    assert acct["device_calls"] == snap["device_calls"]
    assert snap["slo"]["configured"] is True
    assert all(set(i["objectives"]) == {"ttft", "itl", "availability"}
               for i in snap["slo"]["instances"])


def test_interference_report_under_backlog():
    cfg, params = _build()
    server = _server(cfg, params, slots_per_instance=1)
    server.accounting.start()
    for _ in range(3):
        for r in _reqs():
            server.submit(r)
    server.run_until_drained()
    snap = server.accounting.snapshot()
    assert snap["interference"]
    assert {int(w) for w in snap["interference"]} <= {0, 1}
    assert sum(t["queue_wait_s"] for t in snap["per_tenant"].values()) > 0
    assert snap["conservation_rel_err"] < 1e-6


def test_flight_dump_and_conservation_under_driver_crash(tmp_path):
    """A supervised driver crash mid-run under chunked prefill and K=8:
    the ledger conserves below 1e-6 across the replay (which it charges),
    the flight recorder's dump round-trips from disk, and the streams
    are the fault-free ones."""
    cfg, params = _build()
    mix = [Request(i % 2, list(range(1 + i, 6 + 2 * i)), 5 + i) for i in range(6)]
    clean = _server(cfg, params, decode_steps=8, chunk_budget=1)
    for r in mix:
        clean.submit(Request(r.instance, list(r.prompt), r.max_new_tokens))
    want = {r.request_id: r.tokens for r in clean.run_until_drained()}

    inj = FaultInjector([FaultSpec(site="driver", at_call=4)])
    server = _server(cfg, params, decode_steps=8, chunk_budget=1, faults=inj,
                     flight=FlightRecorder(str(tmp_path)), slo=SLOConfig(ttft_ms=200.0))
    server.accounting.start()
    server.tracer.start()
    inj.arm()

    async def main():
        engine = AsyncEngine(server)
        sup = Supervisor(engine, backoff_base_s=0.001)
        async with sup:
            async def client(r):
                s = await engine.submit(r)
                toks = [t async for t in s]
                return s.request_id, toks, await s.result()

            out = await asyncio.gather(*(client(r) for r in mix))
        return out, sup

    out, sup = _run(main())
    assert sup.restarts == 1
    assert {rid: toks for rid, toks, _ in out} == want
    assert all(res.status == "ok" and res.tokens == toks for _, toks, res in out)
    snap = server.accounting.snapshot()
    assert snap["conservation_rel_err"] < 1e-6, snap
    assert sum(t["replay_tokens"] for t in snap["per_tenant"].values()) > 0
    files = sorted(tmp_path.glob("flight-*.json"))
    rec = json.loads(files[0].read_text())
    assert rec["schema"] == "flight/v1" and rec["seq"] == 1
    assert rec["reason"].startswith("crash:")
    assert 0 < rec["extra"]["in_flight"] <= len(mix)
    assert isinstance(rec["queue_depths"], list) and rec["trace_events"]
    assert rec["metrics"]["accounting"]["enabled"] is True
    assert server.flight.latest()[0]["seq"] == 1


def test_quarantine_hook_fires_flight_dump(tmp_path):
    cfg, params = _build()
    server = _server(cfg, params, flight=FlightRecorder(str(tmp_path)))
    server.health.on_quarantine(1)
    rec = server.flight.latest()[0]
    assert rec["reason"] == "quarantine: instance 1" and os.path.exists(rec["path"])


def test_http_slo_routes_and_health_integration():
    cfg, params = _build()
    server = _server(cfg, params, slo=SLOConfig(ttft_ms=60_000.0, itl_ms=60_000.0))

    async def main():
        async with AsyncEngine(server) as engine:
            http = await start_http_server(engine, "127.0.0.1", 0)
            port = http.sockets[0].getsockname()[1]
            st, _, _ = await _req_http(port, "POST", "/v1/completions", payload={
                "model": 0, "prompt": [1, 2, 3], "max_tokens": 4})
            assert st == 200
            _, _, body = await _req_http(port, "GET", "/v1/slo")
            rep = json.loads(body)
            assert rep["configured"] is True and rep["instances"][0]["state"] == "ok"
            assert rep["instances"][0]["objectives"]["ttft"]["count"] > 0
            _, _, body = await _req_http(port, "GET", "/healthz")
            assert json.loads(body)["slo"] == ["ok", "ok"]
            _, _, body = await _req_http(port, "GET", "/v1/models")
            models = json.loads(body)["data"]
            assert [m["slo"] for m in models] == ["ok", "ok"]
            assert [m["health"] for m in models] == ["healthy", "healthy"]
            http.close()
            await http.wait_closed()

    _run(main())
