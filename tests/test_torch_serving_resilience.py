"""The port's resilience layer (``device="cpu"``) against the reference's.

Fault injection, supervised exactly-once recovery, quarantine and
brownout of ``repro_torch.serving`` mirror ``tests/test_serving_resilience.py``
on one device; where both packages can run, the port is held against the
JAX package: the same fault plan and seed give the same ``fired`` list
from both injectors, the port's supervised crash-replay streams equal the
JAX engine's fault-free streams, and either package restores the other's
checkpoint.  Every asyncio wait is bounded (``_run``), so a hang fails one
test instead of eating the suite's time.
"""
import asyncio
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from repro import api as japi
from repro.checkpoint import store as jstore
from repro.configs import registry as jreg
from repro.serving import MultiModelServer as JServer
from repro.serving import Request as JRequest
from repro.serving.resilience import FaultInjector as JInjector
from repro_torch import api
from repro_torch.checkpoint import store
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models.common import TensorParallel
from repro_torch.serving import (
    AsyncEngine,
    BrownoutPolicy,
    EngineClosed,
    FaultInjected,
    FaultInjector,
    FaultSpec,
    HealthMonitor,
    MultiModelServer,
    Request,
    Result,
    Supervisor,
    start_http_server,
)
from repro_torch.serving.obs import render_prometheus

ARCH = "tinyllama-1.1b"
_PARAMS = {}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _build(m=2, arch=ARCH):
    """(cfg, port params) of the f32 smoke config at ``m`` instances."""
    if (arch, m) not in _PARAMS:
        cfg = registry.get_smoke_config(arch).with_(num_instances=m)
        _PARAMS[arch, m] = (cfg, api.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    return _PARAMS[arch, m]


def _server(cfg, params, **kw):
    kw.setdefault("slots_per_instance", 2)
    kw.setdefault("max_context", 48)
    return MultiModelServer(cfg, params, device="cpu", **kw)


def _reqs(m=2, cls=Request):
    base = [cls(instance=0, prompt=[1, 2, 3], max_new_tokens=4),
            cls(instance=1, prompt=[4, 5], max_new_tokens=4),
            cls(instance=0, prompt=[7], max_new_tokens=3),
            cls(instance=1, prompt=[3, 3, 3, 3, 3], max_new_tokens=3)]
    if m > 2:
        base.append(cls(instance=2, prompt=[9, 8], max_new_tokens=4))
    return base


def _clean_streams(cfg, params, m=2, **kw):
    """The fault-free greedy run: {request_id: (tokens, status)}."""
    srv = _server(cfg, params, **kw)
    for r in _reqs(m):
        srv.try_submit(r)
    return {r.request_id: (r.tokens, r.status) for r in srv.run_until_drained()}


def _run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _stream_all(engine, reqs):
    async def client(r):
        stream = await engine.submit(r)
        toks = [t async for t in stream]
        return stream.request_id, toks, await stream.result()

    return await asyncio.gather(*(client(r) for r in reqs))


# -- the injector: free when disarmed, the reference's schedule when armed ----


def test_disarmed_injector_runs_no_code(monkeypatch):
    cfg, params = _build()
    inj = FaultInjector([FaultSpec(site="decode", at_call=1)])

    def boom(*a, **k):
        raise AssertionError("injector code ran while disarmed")

    for name in ("on_call", "arm", "reset"):
        monkeypatch.setattr(inj, name, boom)
    server = _server(cfg, params, faults=inj)
    for r in _reqs():
        server.try_submit(r)
    out = server.run_until_drained()
    assert all(r.status == "ok" for r in out)
    assert inj.calls == {} and inj.fired == []


PLANS = [
    {"seed": 7, "faults": [{"site": "decode", "kind": "nan", "prob": 0.3, "times": None}]},
    {"seed": 3, "faults": [{"site": "driver", "at_call": 2},
                           {"site": "decode", "kind": "nan", "instance": 1, "every": 5,
                            "times": 2},
                           {"site": "prefill", "kind": "raise", "prob": 0.5, "times": 3}]},
]


@pytest.mark.parametrize("plan", PLANS, ids=["prob", "mixed"])
def test_fault_schedule_equals_reference(plan):
    """Same plan and seed: the port's injector fires where the
    reference's does, call for call (raises caught, poison sets equal),
    and ``reset`` replays the schedule."""
    sites = ["decode", "prefill", "driver", "scatter"] * 16

    def drive(inj):
        log = []
        for s in sites:
            try:
                log.append(sorted(inj.on_call(s)))
            except Exception as e:               # the kind "raise"
                log.append(type(e).__name__)
        return list(inj.fired), log

    mine = FaultInjector.from_json(json.dumps(plan)).arm()
    ref = JInjector.from_json(json.dumps(plan)).arm()
    got, want = drive(mine), drive(ref)
    assert got == want and got[0]
    mine.reset()
    assert drive(mine) == want


def test_fault_plan_json_roundtrip(tmp_path):
    plan = PLANS[1]
    p = tmp_path / "plan.json"
    p.write_text(json.dumps(plan))
    for inj in (FaultInjector.from_json(json.dumps(plan)), FaultInjector.from_json(str(p))):
        assert inj.seed == 3 and len(inj.plan) == 3
        assert inj.plan[1].kind == "nan" and inj.plan[1].instance == 1
    with pytest.raises(ValueError):
        FaultSpec(site="nowhere", at_call=1)
    with pytest.raises(ValueError):
        FaultSpec(site="decode")


# -- checkpoints ----------------------------------------------------------------


def test_checkpoint_fault_site(tmp_path):
    tree = {"w": torch.ones(2, 2)}
    store.save(tmp_path / "ckpt", tree)
    inj = FaultInjector([FaultSpec(site="checkpoint", at_call=1)]).arm()
    with pytest.raises(FaultInjected):
        store.restore(tmp_path / "ckpt", tree, faults=inj)
    back = store.restore(tmp_path / "ckpt", tree, faults=inj)   # fired once
    assert torch.equal(back["w"], tree["w"])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "xlstm-1.3b"])
def test_checkpoint_crosses_packages(tmp_path, arch):
    """A checkpoint ``repro.checkpoint.store.save`` wrote restores into the
    port's layout (the bridge's params, equal bit for bit), the key sets
    of both packages' files are equal, and the reference restores what
    the port saved."""
    jcfg = jreg.get_smoke_config(arch).with_(num_instances=2)
    cfg = registry.get_smoke_config(arch).with_(num_instances=2)
    jp = japi.init(jcfg, jax.random.PRNGKey(0))
    jstore.save(tmp_path / "ref", jp)
    want = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    got = store.restore_params(tmp_path / "ref", cfg, want, "cpu")
    a, b = dict(want.named_parameters()), dict(got.named_parameters())
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

    store.save(tmp_path / "port", want, extra={"step": 3})
    keys = lambda d: set(json.loads((tmp_path / d / "manifest.json").read_text())["leaves"])
    assert keys("port") == keys("ref")
    back = jstore.restore(tmp_path / "port", jp)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(x, np.float32), np.asarray(y, np.float32))


def test_checkpoint_bfloat16_roundtrip(tmp_path):
    tree = {"a": [torch.randn(3, 4).bfloat16(), None, {"b": torch.arange(5)}]}
    store.save(tmp_path / "c", tree)
    info = json.loads((tmp_path / "c" / "manifest.json").read_text())["leaves"]
    assert set(info) == {"a/0", "a/2/b"} and info["a/0"]["dtype"] == "bfloat16"
    back = store.restore(tmp_path / "c", tree)
    assert back["a"][1] is None
    assert torch.equal(back["a"][0], tree["a"][0]) and back["a"][0].dtype == torch.bfloat16
    assert torch.equal(back["a"][2]["b"], tree["a"][2]["b"])


# -- crash recovery: exactly once ------------------------------------------------


def test_sync_crash_recovery_bit_identical():
    cfg, params = _build()
    want = _clean_streams(cfg, params)
    inj = FaultInjector([FaultSpec(site="decode", at_call=3)])
    srv = _server(cfg, params, faults=inj)
    emitted = {}
    srv.on_token = lambda rid, tok, fin: emitted.setdefault(rid, []).append(tok)
    for r in _reqs():
        srv.try_submit(r)
    inj.arm()
    done, crashes = [], 0
    while srv.busy() or srv._pending_failures:
        try:
            done.extend(srv.step())
        except FaultInjected:
            crashes += 1
            for req, _gen in srv.reset_serving_state():
                srv.requeue(req, emitted=list(emitted.get(req.request_id, [])))
    assert crashes == 1
    assert {r.request_id: (r.tokens, r.status) for r in done} == want
    assert emitted == {rid: toks for rid, (toks, _s) in want.items()}
    assert srv.metrics.replay_mismatches == 0 and srv.metrics.replayed_tokens > 0


def test_supervised_crash_replay_equals_jax_engine():
    """A driver, a decode and a chunk-call raise under a Supervisor (K=4,
    chunks of 2): the port's streams equal the JAX engine's fault-free
    streams, each injected raise explains exactly one restart, and no
    replayed token differs from the one delivered."""
    jcfg = jreg.get_smoke_config(ARCH).with_(num_instances=2)
    cfg = registry.get_smoke_config(ARCH).with_(num_instances=2)
    jp = japi.init(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(slots_per_instance=2, max_context=48, prefill_chunk=2, chunk_budget=1,
              decode_steps=4)
    mix = [(i % 2, list(range(1 + i, 4 + 2 * i)), 6 + i) for i in range(6)]
    ref = JServer(jcfg, jp, **kw)
    for inst, prompt, n in mix:
        ref.submit(JRequest(inst, prompt, n))
    want = {r.request_id: r.tokens for r in ref.run_until_drained()}

    inj = FaultInjector([FaultSpec(site="driver", at_call=3),
                         FaultSpec(site="decode", at_call=4),
                         FaultSpec(site="prefill", at_call=2)])
    srv = MultiModelServer(cfg, params, device="cpu", faults=inj, **kw)
    inj.arm()

    async def main():
        engine = AsyncEngine(srv)
        sup = Supervisor(engine, backoff_base_s=0.001, max_retries=10)
        async with sup:
            out = await _stream_all(engine, [Request(*r) for r in mix])
        return out, sup

    out, sup = _run(main())
    got = {rid: toks for rid, toks, _res in out}
    assert got == want
    assert all(res.status == "ok" and res.tokens == toks for _r, toks, res in out)
    crashes = [f for f in inj.fired if f[2] == "raise"]
    assert sorted(s for s, _, _ in crashes) == ["decode", "driver", "prefill"]
    assert sup.restarts == len(crashes)
    assert srv.metrics.replay_mismatches == 0
    assert all(r["time_to_recover_s"] >= 0 for r in sup.snapshot()["recoveries"])


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
def test_watchdog_fires_on_injected_stall(hard):
    """A decode step stalled past the watchdog is counted and recovered:
    soft, the stalled step is waited out on the same server; hard, a new
    server from ``server_factory`` takes over (sharing only the params)."""
    cfg, params = _build()

    def warm(s):
        s.try_submit(Request(instance=0, prompt=[1, 2], max_new_tokens=2))
        s.run_until_drained()

    srv0 = _server(cfg, params)
    warm(srv0)                 # align request-id ranges with the faulted run
    for r in _reqs():
        srv0.try_submit(r)
    want = {r.request_id: (r.tokens, r.status) for r in srv0.run_until_drained()}

    inj = FaultInjector([FaultSpec(site="decode", kind="stall", stall_s=0.6, at_call=2)])
    srv = _server(cfg, params, faults=inj)
    warm(srv)
    inj.arm()
    made, log = [], []
    step, reset = srv.step, srv.reset_serving_state

    def logged_step():
        log.append("step")
        out = step()
        log.append("stepped")
        return out

    def logged_reset():
        log.append("reset")
        return reset()

    srv.step, srv.reset_serving_state = logged_step, logged_reset

    def factory():
        made.append(_server(cfg, params))
        return made[-1]

    async def main():
        engine = AsyncEngine(srv)
        sup = Supervisor(engine, watchdog_s=0.15, backoff_base_s=0.001,
                         server_factory=factory if hard else None)
        async with sup:
            out = await _stream_all(engine, _reqs())
        return out, sup, engine

    out, sup, engine = _run(main())
    assert {rid: (toks, res.status) for rid, toks, res in out} == want
    assert sup.watchdog_timeouts == 1 and sup.restarts == 1
    if hard:
        assert engine.server is made[0] and engine.server.params is srv.params
        assert engine.server.cache.k.data_ptr() != srv.cache.k.data_ptr()
    else:
        # the soft path waits the stalled step out before it resets
        i = log.index("reset")
        assert log[:i].count("step") == log[:i].count("stepped")


def test_retry_budget_exhaustion_gives_up_cleanly():
    cfg, params = _build()
    inj = FaultInjector([FaultSpec(site="driver", every=1, times=None)])
    srv = _server(cfg, params, faults=inj)
    inj.arm()

    async def main():
        engine = AsyncEngine(srv)
        sup = Supervisor(engine, max_restarts=2, backoff_base_s=0.001, max_retries=100)
        sup.start()
        out = await _stream_all(engine, _reqs())
        with pytest.raises(EngineClosed):
            await engine.submit(Request(instance=0, prompt=[1], max_new_tokens=1))
        await engine.aclose()
        return out, sup

    out, sup = _run(main())
    assert all(res.status == "error" and "permanently" in res.error for _r, _t, res in out)
    assert sup.restarts == 2


def test_per_request_retry_budget_fails_only_that_request():
    """A request live across more restarts than its retry budget ends
    with an error Result keeping its delivered tokens; the engine keeps
    serving the rest."""
    cfg, params = _build()
    inj = FaultInjector([FaultSpec(site="decode", every=2, times=3)])
    srv = _server(cfg, params, faults=inj)
    inj.arm()

    async def main():
        engine = AsyncEngine(srv)
        sup = Supervisor(engine, backoff_base_s=0.001, max_retries=1)
        async with sup:
            long = await engine.submit(Request(instance=0, prompt=[1, 2], max_new_tokens=30))
            res = await long.result()
            late = await engine.submit(Request(instance=1, prompt=[4, 5], max_new_tokens=3))
            return res, list(long.emitted), await late.result(), sup

    res, emitted, late, sup = _run(main())
    assert res.status == "error" and "retry budget" in res.error
    assert res.tokens == emitted
    assert sup.retry_budget_exhausted == 1
    assert late.status == "ok" and len(late.tokens) == 3


def test_unsupervised_driver_death_propagates():
    cfg, params = _build()
    inj = FaultInjector([FaultSpec(site="decode", at_call=2)])
    srv = _server(cfg, params, faults=inj)
    inj.arm()

    async def main():
        engine = AsyncEngine(srv)
        s1 = await engine.submit(Request(instance=0, prompt=[1, 2, 3], max_new_tokens=6))
        s2 = await engine.submit(Request(instance=1, prompt=[4, 5], max_new_tokens=6))
        r1, r2 = await s1.result(), await s2.result()
        assert r1.status == "error" and "driver failed" in r1.error
        assert r2.status == "error"
        assert r1.tokens == list(s1.emitted) and len(r1.tokens) >= 1
        assert engine.driver_status() == "failed"
        with pytest.raises(EngineClosed):
            await engine.submit(Request(instance=0, prompt=[1], max_new_tokens=1))
        await engine.drain()
        await engine.aclose()

    _run(main())


@pytest.mark.parametrize("site", ["scatter", "prefill"])
def test_step_exception_leaks_no_slot(site):
    cfg, params = _build()
    inj = FaultInjector([FaultSpec(site=site, at_call=1)])
    srv = _server(cfg, params, faults=inj)
    for r in _reqs():
        srv.try_submit(r)
    inj.arm()
    out = srv.run_until_drained()
    assert any(r.status == "error" for r in out)
    assert not srv.slot_busy.any() and not srv.slot_prefilling.any()
    assert srv.prefill.in_flight() == 0 and not srv._reserved
    assert srv.scheduler.total_pending() == 0
    srv.try_submit(Request(instance=0, prompt=[7], max_new_tokens=3))
    assert [r.status for r in srv.run_until_drained()] == ["ok"]


# -- the NaN/Inf guard and quarantine --------------------------------------------


def test_nan_quarantines_only_poisoned_instance():
    cfg, params = _build(m=3)
    want = _clean_streams(cfg, params, m=3)
    inj = FaultInjector([FaultSpec(site="decode", kind="nan", instance=1, at_call=2)])
    hm = HealthMonitor(3, quarantine_steps=4)
    srv = _server(cfg, params, faults=inj, health=hm)
    for r in _reqs(3):
        srv.try_submit(r)
    inj.arm()
    got = {r.request_id: (r.tokens, r.status) for r in srv.run_until_drained()}
    assert got[1][1] == "error" and got[3][1] == "error"
    assert all(got[rid] == want[rid] for rid in want if rid not in (1, 3))
    assert hm.states() == ["healthy", "quarantined", "healthy"]
    rej = srv.try_submit(Request(instance=1, prompt=[1], max_new_tokens=2))
    assert isinstance(rej, Result) and rej.status == "unavailable"
    rounds = 0
    while hm.state(1) == "quarantined" and rounds < 50:
        srv.try_submit(Request(instance=0, prompt=[9], max_new_tokens=1))
        srv.run_until_drained()
        rounds += 1
    assert hm.state(1) == "probation"
    srv.try_submit(Request(instance=1, prompt=[4, 5], max_new_tokens=4))
    back = srv.run_until_drained()
    assert back[-1].status == "ok" and back[-1].tokens == want[1][0]
    assert hm.state(1) == "healthy"
    assert hm.snapshot()["quarantine_events"] == 1


def test_nonfinite_logits_guard_on_the_sampled_path():
    """The guard the device computes: instance 1's final norm made NaN
    gives non-finite logits on the sampled path; its requests fail, its
    row quarantines, instance 0 streams as before."""
    cfg, params = _build()
    kw = dict(temperature=0.7, top_k=4, seed=5)
    want = _clean_streams(cfg, params, **kw)
    bad = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        bad["final_norm"][1] = float("nan")
    srv = _server(cfg, bad, **kw)
    for r in _reqs():
        srv.try_submit(r)
    got = {r.request_id: (r.tokens, r.status) for r in srv.run_until_drained()}
    assert got[0] == want[0] and got[2] == want[2]
    assert got[1][1] == "error" and got[3][1] == "error"
    assert srv.health.states() == ["healthy", "quarantined"]


# -- brownout ---------------------------------------------------------------------


def test_brownout_sheds_by_queue_age():
    cfg, params = _build()
    pol = BrownoutPolicy(shed_age_s=0.05)
    srv = _server(cfg, params, policy=pol, slots_per_instance=1)
    for _ in range(4):
        srv.try_submit(Request(instance=0, prompt=[1, 2], max_new_tokens=2))
    time.sleep(0.1)
    shed = [r for r in srv.step() if r.status == "shed"]
    assert shed and all("overload" in r.error for r in shed)
    assert pol.shed_total == len(shed)
    assert srv.metrics.snapshot()["shed"] == len(shed)
    assert all(r.status == "ok" for r in srv.run_until_drained())


def test_brownout_degraded_mode_caps_max_new():
    cfg, params = _build()
    pol = BrownoutPolicy(degrade_depth=2, degrade_steps=2, degraded_max_new=2)
    srv = _server(cfg, params, policy=pol, slots_per_instance=1)
    for _ in range(6):
        srv.try_submit(Request(instance=0, prompt=[1, 2], max_new_tokens=8))
        srv.try_submit(Request(instance=1, prompt=[3, 4], max_new_tokens=8))
    steps = 0
    while not pol.degraded and steps < 50:
        srv.step()
        steps += 1
    assert pol.degraded
    late = Request(instance=0, prompt=[5], max_new_tokens=16)
    srv.try_submit(late)
    assert late.max_new_tokens == 2 and pol.capped_total >= 1
    capped = [r for r in srv.run_until_drained() if r.request_id == late.request_id]
    assert capped[0].status == "ok" and len(capped[0].tokens) == 2


# -- HTTP: 503, /healthz, Prometheus ------------------------------------------------


async def _raw_http(port, method, path, payload=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = b"" if payload is None else json.dumps(payload).encode()
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                 f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, rest = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {k.strip().lower(): v.strip()
               for k, _, v in (ln.partition(":") for ln in lines[1:])}
    return int(lines[0].split()[1]), headers, rest


def test_http_quarantine_503_healthz_and_prometheus():
    cfg, params = _build()
    inj = FaultInjector([FaultSpec(site="decode", kind="nan", instance=0, at_call=1)])
    srv = _server(cfg, params, faults=inj, health=HealthMonitor(2, quarantine_steps=1024))

    async def main():
        engine = AsyncEngine(srv)
        sup = Supervisor(engine, backoff_base_s=0.001)
        sup.start()
        http = await start_http_server(engine, "127.0.0.1", 0)
        port = http.sockets[0].getsockname()[1]
        inj.arm()
        st, _h, body = await _raw_http(port, "POST", "/v1/completions",
                                       {"model": 0, "prompt": [1, 2, 3], "max_tokens": 4})
        assert st == 200 and json.loads(body)["status"] == "error"
        st, headers, body = await _raw_http(port, "POST", "/v1/completions",
                                            {"model": 0, "prompt": [1], "max_tokens": 2})
        assert st == 503 and "retry-after" in headers
        assert json.loads(body)["error"]["reason"] == "unavailable"
        st, _h, body = await _raw_http(port, "POST", "/v1/completions",
                                       {"model": 1, "prompt": [4, 5], "max_tokens": 3})
        assert st == 200 and json.loads(body)["status"] == "ok"
        st, _h, body = await _raw_http(port, "GET", "/healthz")
        h = json.loads(body)
        assert st == 200 and h["instance_health"] == ["quarantined", "healthy"]
        assert h["resilience"]["driver_restarts"] == 0
        text = render_prometheus(srv.metrics.snapshot())
        for line in ("repro_driver_restarts_total 0", "repro_instances_quarantined 1",
                     'repro_instance_health_state{instance="0",state="quarantined"} 1',
                     'repro_instance_health_state{instance="1",state="healthy"} 1'):
            assert line in text, line
        http.close()
        await http.wait_closed()
        await engine.aclose()

    _run(main())


def test_recovery_events_land_in_trace_and_metrics():
    cfg, params = _build()
    inj = FaultInjector([FaultSpec(site="driver", at_call=2)])
    srv = _server(cfg, params, faults=inj)
    srv.tracer.start()
    inj.arm()

    async def main():
        engine = AsyncEngine(srv)
        async with Supervisor(engine, backoff_base_s=0.001):
            return await _stream_all(engine, _reqs())

    out = _run(main())
    assert all(res.status == "ok" for _r, _t, res in out)
    srv.tracer.stop()
    names = {e["name"] for e in srv.tracer.export_chrome()["traceEvents"]}
    assert any(n.startswith("restart") for n in names) and "requeue" in names
    snap = srv.metrics.snapshot()
    assert snap["requeued"] == len(_reqs())
    assert snap["replayed_tokens"] == snap["resilience"]["tokens_replayed"]
    assert snap["replay_mismatches"] == 0


# -- recovery state, the mesh refusal, the unfolded tail -------------------------


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "xlstm-1.3b"])
def test_reset_serving_state_restores_cache_in_place(arch):
    """``reset_serving_state`` writes the initial cache back into the live
    tensors (no second grid cache), recurrent state's non-zero initial
    values included, and the replayed streams equal a fresh server's."""
    cfg, params = _build(arch=arch)
    srv = _server(cfg, params, temperature=0.8, top_k=4, seed=3)
    for r in _reqs():
        srv.try_submit(r)
    srv.step()
    srv.step()
    leaves = lambda c: [t for t in jax.tree.leaves(c, is_leaf=torch.is_tensor)
                        if torch.is_tensor(t)]
    ptrs = [t.data_ptr() for t in leaves(srv.cache)]
    live = srv.reset_serving_state()
    assert len(live) == len(_reqs()) and not srv.busy()
    fresh = api.make_cache(cfg, cfg.num_instances, 2, 48, "cpu")
    assert [t.data_ptr() for t in leaves(srv.cache)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(leaves(srv.cache), leaves(fresh)))
    for req, _gen in live:
        srv.requeue(req)
    got = {r.request_id: r.tokens for r in srv.run_until_drained()}
    want = {rid: toks for rid, (toks, _s) in
            _clean_streams(cfg, params, temperature=0.8, top_k=4, seed=3).items()}
    assert got == want


def test_mesh_handle_refuses_the_periphery():
    """Given a ``tp`` handle, the async frontend, the supervisor and an
    armed fault site raise; the sync engine serves as before."""
    cfg, params = _build()
    tp = TensorParallel(0, 1, None, torch.device("cpu"), "gloo")
    inj = FaultInjector([FaultSpec(site="decode", at_call=99)])
    srv = _server(cfg, params, tp=tp, faults=inj)
    with pytest.raises(NotImplementedError, match="one device"):
        AsyncEngine(srv)
    with pytest.raises(NotImplementedError, match="one device"):
        Supervisor(SimpleNamespace(server=srv))
    srv.try_submit(Request(instance=0, prompt=[1, 2], max_new_tokens=3))
    assert [r.status for r in srv.run_until_drained()] == ["ok"]
    assert srv.metrics.snapshot()["mesh"] == {"shape": {"data": 1, "model": 1}, "devices": 1}
    inj.arm()
    srv.try_submit(Request(instance=0, prompt=[1, 2], max_new_tokens=3))
    with pytest.raises(NotImplementedError, match="one device"):
        srv.run_until_drained()


def test_unfolded_tail_gives_the_folded_streams():
    """``tail_fold=False`` (single-token tail calls) serves the JAX
    engine's ``tail_fold=False`` streams on the same params, and the
    folded path's, in two chunk widths against one."""
    jcfg = jreg.get_smoke_config(ARCH).with_(num_instances=2)
    cfg = registry.get_smoke_config(ARCH).with_(num_instances=2)
    jp = japi.init(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    reqs = [(i % 2, list(range(1 + i, 8 + 3 * i)), 3 + i % 3) for i in range(6)]
    kw = dict(slots_per_instance=2, max_context=48, prefill_chunk=4, decode_steps=4)
    ref = JServer(jcfg, jp, tail_fold=False, **kw)
    for inst, prompt, n in reqs:
        ref.submit(JRequest(inst, prompt, n))
    want = {r.request_id: r.tokens for r in ref.run_until_drained()}

    def run(fold):
        srv = MultiModelServer(cfg, params, device="cpu", tail_fold=fold, **kw)
        for inst, prompt, n in reqs:
            srv.submit(Request(inst, prompt, n))
        res = srv.run_until_drained()
        assert [r.status for r in res] == ["ok"] * len(reqs)
        out = {r.request_id: r.tokens for r in res}
        return out, srv.prefill.compiled_shapes, srv.prefill.device_calls

    folded, unfolded = run(True), run(False)
    assert [len(want[i]) for i in range(len(reqs))] == [n for _i, _p, n in reqs]
    assert unfolded[0] == want
    assert folded[0] == want
    assert (folded[1], unfolded[1]) == (1, 2)
    assert unfolded[2] > folded[2]


def test_serve_cli_stream_counts_failed_requests(tmp_path, capsys):
    """``--stream --fault-plan``: a request failed by the NaN guard is
    reported by status beside the clean ones, not dropped from the run."""
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"seed": 0, "faults": [
        {"site": "decode", "kind": "nan", "instance": 1, "at_call": 1}]}))
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--num-instances", "2",
            "--requests", "4", "--max-new", "4", "--decode-steps", "4", "--stream"]
    serve.main(argv)
    out = capsys.readouterr().out
    assert "served 4 requests, 16 tokens" in out and "requests by status" not in out
    serve.main(argv + ["--fault-plan", str(plan)])
    out = capsys.readouterr().out
    assert "requests by status: error 2, ok 2" in out
    assert "served 4 requests, 8 tokens" in out
