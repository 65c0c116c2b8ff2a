"""The serving periphery on the card (marked ``cuda``; skips without one).

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_serving_cuda.py

No JAX here: the card's streams are held against the port's own
synchronous engine on the same card.
"""
import asyncio

import pytest
import torch

from repro_torch import api
from repro_torch.configs import registry
from repro_torch.serving import (AsyncEngine, FaultInjector, FaultSpec, MultiModelServer,
                                 Request, Supervisor)

pytestmark = pytest.mark.cuda

MIX = [(0, [1, 2, 3], 4), (1, [4, 5], 4), (0, [7], 3), (1, [3, 3, 3, 3, 3], 3),
       (0, [2, 2], 3), (1, [9, 8, 7], 4)]


def test_supervised_async_streams_on_the_card():
    """f32 smoke config: async clients under a supervisor, with a driver
    and a chunk-call raise injected, get the sync engine's streams, one
    restart per raise, no replayed token differing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = registry.get_smoke_config("tinyllama-1.1b").with_(num_instances=2)
    dev = torch.device("cuda")
    params = api.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    kw = dict(slots_per_instance=2, max_context=48, prefill_chunk=2, chunk_budget=1,
              decode_steps=4, device=dev)
    reqs = lambda: [Request(i, list(p), n) for i, p, n in MIX]
    sync = MultiModelServer(cfg, params, **kw)
    for r in reqs():
        sync.submit(r)
    want = {r.request_id: r.tokens for r in sync.run_until_drained()}
    inj = FaultInjector([FaultSpec(site="driver", at_call=2), FaultSpec(site="prefill", at_call=2)])
    srv = MultiModelServer(cfg, params, faults=inj, **kw)
    inj.arm()

    async def main():
        engine = AsyncEngine(srv)
        async with Supervisor(engine, backoff_base_s=0.001, max_retries=8) as sup:
            streams = [await engine.submit(r) for r in reqs()]
            out = {s.request_id: (await s.result()).tokens for s in streams}
        return out, sup

    got, sup = asyncio.run(asyncio.wait_for(main(), 120))
    assert got == want
    assert sup.restarts == sum(f[2] == "raise" for f in inj.fired) == 2
    assert srv.metrics.replay_mismatches == 0
