"""The port's serving engine (``device="cpu"``) against the JAX engine.

Same merged weights on both sides (``repro.api.init`` carried across
with the bridge), the request mix of test_megakernel.py (mixed budgets:
lanes die mid-block under K=8), for the dense family and for xLSTM
(ssm: recurrent state instead of a KV cache).  Greedy streams must be
equal token for token, and the device-call counts of the two runtimes
equal: prefill chunk calls and decode dispatches (one per engine step).
"""
import numpy as np
import pytest
import torch

import jax

from repro import api as japi
from repro.configs import registry as jreg
from repro.serving import MultiModelServer as JServer
from repro.serving import Request as JRequest
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.serving import MultiModelServer, Request

REQS = [  # (instance, prompt, max_new_tokens)
    (0, [1, 2, 3], 7), (1, [4, 5], 5), (0, [7], 3),
    (1, [3, 3, 3, 3, 3], 6), (0, [2, 2], 4), (1, [9, 8, 7], 8),
]


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        jcfg = jreg.get_smoke_config(arch).with_(num_instances=2)
        tcfg = treg.get_smoke_config(arch).with_(num_instances=2)
        jp = japi.init(jcfg, jax.random.PRNGKey(0))
        _PARAMS[arch] = (jcfg, tcfg, jp,
                         params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu"))
    return _PARAMS[arch]


def _drain(server, req_cls):
    calls = [0]
    inner = server._step

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    server._step = counted
    for inst, prompt, n in REQS:
        server.submit(req_cls(inst, list(prompt), n))
    streams = {r.request_id: r.tokens for r in server.run_until_drained()}
    return streams, calls[0], server.prefill.device_calls


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen1.5-0.5b", "xlstm-1.3b"])
@pytest.mark.parametrize("k", [1, 8])
def test_streams_and_call_counts_match_jax_engine(arch, k):
    jcfg, tcfg, jp, tp = _params(arch)
    kw = dict(slots_per_instance=2, max_context=48, temperature=0.0, decode_steps=k)
    want, jdec, jpre = _drain(JServer(jcfg, jp, **kw), JRequest)
    got, tdec, tpre = _drain(MultiModelServer(tcfg, tp, device="cpu", **kw), Request)
    assert want and all(len(t) > 0 for t in want.values())
    assert got == want
    assert (tdec, tpre) == (jdec, jpre)


def test_streams_identical_k1_k8_long_prompts():
    """Prompts over several chunks, K=1 vs K=8, within the port."""
    _, tcfg, _, tp = _params("tinyllama-1.1b")
    rng = np.random.default_rng(0)
    reqs = [(i % 2, rng.integers(1, 257, int(rng.integers(5, 70))).tolist(), 3 + i)
            for i in range(6)]

    def run(k):
        srv = MultiModelServer(tcfg, tp, slots_per_instance=2, max_context=96,
                               prefill_chunk=16, decode_steps=k, device="cpu")
        for inst, prompt, n in reqs:
            srv.submit(Request(inst, prompt, n))
        return {r.request_id: r.tokens for r in srv.run_until_drained()}

    assert run(1) == run(8)


@pytest.mark.parametrize("policy", ["round-robin", "token-budget"])
def test_sampled_streams_and_policies(policy):
    """Temperature / top-k sampling from the server's generator: every
    token lies in the vocabulary, the seed reproduces the streams, and
    top_k=1 is greedy whatever the temperature."""
    _, tcfg, _, tp = _params("tinyllama-1.1b")

    def run(**kw):
        srv = MultiModelServer(tcfg, tp, slots_per_instance=2, max_context=48,
                               scheduler=policy, decode_steps=4, device="cpu", **kw)
        for inst, prompt, n in REQS:
            srv.submit(Request(inst, list(prompt), n))
        return {r.request_id: r.tokens for r in srv.run_until_drained()}

    a = run(temperature=0.8, top_k=5, seed=3)
    assert a == run(temperature=0.8, top_k=5, seed=3)
    assert all(0 <= t < tcfg.vocab_size for toks in a.values() for t in toks)
    assert run(temperature=0.8, top_k=1, seed=4) == run(temperature=0.0)


def test_cancel_frees_the_slot():
    _, tcfg, _, tp = _params("tinyllama-1.1b")
    srv = MultiModelServer(tcfg, tp, slots_per_instance=1, max_context=48,
                           device="cpu")
    a = srv.submit(Request(0, [1, 2, 3], 20))
    b = srv.submit(Request(0, [4, 5], 3))          # waits for the one slot
    srv.step()
    srv.step()
    assert srv.slot_busy[0, 0] and srv.scheduler.depth(0) == 1
    res = srv.cancel(a)
    assert res.status == "cancelled" and len(res.tokens) >= 1
    assert not srv.slot_busy[0, 0]
    done = srv.run_until_drained()
    assert [r.request_id for r in done] == [b] and len(done[0].tokens) == 3
    assert srv.cancel(a) is None
