"""The data axis of the port's serving mesh for the audio and vlm families
(``--mesh-shape 2x1``), on the CPU, against the JAX package.

One 2x1 spawn (``mesh.spawn``, gloo) serves whisper-smoke at M=2 (the
instance rows split over the two data ranks), whisper-smoke at M=1 with 2
slots (the slots split: "batch") and internvl2-smoke at M=2.  Every
rank's greedy streams must equal the JAX package's single-device
engine's (f32): a data rank holds its block of the grid (its rows of the
cross-attention cache among them), the zero frames or patch embeddings
of its prefill lanes, and the slot surgery of its own slots, and no token
changes.  Prompts have at least 2 tokens: the reference prefills no
prefix (frames, patches) for a 1-token prompt.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import registry as jreg
from repro.serving import MultiModelServer as JServer
from repro.serving import Request as JRequest
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.launch import mesh, serve
from repro_torch.models import shardings
from repro_torch.serving import Request

SERVER_KW = dict(slots_per_instance=2, max_context=64, prefill_chunk=5, prefill_lanes=3,
                 chunk_budget=2, decode_steps=8)
# name -> (arch, overrides, the data split the 2x1 mesh takes)
CONFIGS = {
    "audio": ("whisper-small", dict(num_instances=2), "instances"),
    "audio_slots": ("whisper-small", dict(num_instances=1), "batch"),
    "vlm": ("internvl2-26b", dict(num_instances=2), "instances"),
}
_PARAMS, _RUNS = {}, {}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _params(name):
    if name not in _PARAMS:
        arch, kw, _ = CONFIGS[name]
        jcfg = jreg.get_smoke_config(arch).with_(**kw)
        tcfg = treg.get_smoke_config(arch).with_(**kw)
        jp = jax.jit(lambda key: japi.init(jcfg, key))(jax.random.PRNGKey(0))
        _PARAMS[name] = (jcfg, tcfg, jp,
                         params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu"))
    return _PARAMS[name]


def _requests(req_cls, cfg):
    """Prompts of 2 to 18 tokens, mixed budgets, so slots stop mid-block."""
    rng = np.random.default_rng(4)
    return [req_cls(i % cfg.num_instances, rng.integers(1, cfg.vocab_size, n).tolist(),
                    3 + i % 4)
            for i, n in enumerate((2, 7, 18, 3, 12))]


def _jax_streams(name):
    if ("jax", name) not in _RUNS:
        jcfg, _, jp, _ = _params(name)
        srv = JServer(jcfg, jp, temperature=0.0, **SERVER_KW)
        for r in _requests(JRequest, jcfg):
            srv.submit(r)
        _RUNS["jax", name] = {r.request_id: r.tokens for r in srv.run_until_drained()}
    return _RUNS["jax", name]


def _mesh_runs():
    """Per rank of one 2x1 spawn: {config: serve_rank's result}."""
    if "mesh" not in _RUNS:
        calls = [(serve.serve_rank, _params(n)[1], _params(n)[3],
                  _requests(Request, _params(n)[1]), SERVER_KW) for n in CONFIGS]
        ranks = mesh.spawn(mesh.in_turn, 1, *calls, device="cpu", data=2)
        _RUNS["mesh"] = [dict(zip(CONFIGS, r)) for r in ranks]
    return _RUNS["mesh"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_streams_match_jax_single_device(name):
    """The data split is the one named; every rank's greedy streams equal
    the JAX single-device engine's; the ranks made the same device calls
    and record the mesh."""
    _, tcfg, _, _ = _params(name)
    rows = [shardings.data_rows(tcfg.num_instances, SERVER_KW["slots_per_instance"],
                                SimpleNamespace(rank=i, size=2)) for i in range(2)]
    assert all(r.split == CONFIGS[name][2] for r in rows)
    want = _jax_streams(name)
    assert want and all(want.values())
    runs = [r[name] for r in _mesh_runs()]
    for r in runs:
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["streams"] == want
        assert (r["decode_blocks"], r["prefill_calls"]) == (runs[0]["decode_blocks"],
                                                            runs[0]["prefill_calls"])
        assert r["snapshot"]["mesh"] == {"shape": {"data": 2, "model": 1}, "devices": 2}
