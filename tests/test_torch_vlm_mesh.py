"""The vlm family (internvl2) on a model-parallel mesh (``models/vlm.py``
under ``tp``, dense's rules in ``models/shardings.py``, the projector
whole on every rank) against ``repro.models.vlm`` on the CPU,
internvl2-smoke in f32.

* The sliced draw: a rank's shard drawn layer by layer
  (``launch/serve.random_merged`` with ``shardings.vlm_cut``) equals the
  slice of the whole draw bit for bit, the projector whole.
* The engine on 1x2 (4 / 2 heads split "kv", d_ff split) and 1x4 gloo
  meshes (the smoke config's 4 / 2 heads do not split "kv" over 4 ranks,
  so its layers stay whole on every rank), one spawn per mesh: every
  rank's greedy streams equal the JAX single-device engine's (zero patch
  embeddings, as both engines serve them).
"""
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

ARCH = "internvl2-26b"
M = 2
SERVER_KW = dict(slots_per_instance=2, max_context=64, prefill_chunk=5, prefill_lanes=3,
                 chunk_budget=2, decode_steps=8)
MESHES = [2, 4]


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_rank_draw_equals_slice_of_whole_draw():
    """Each rank of 1x2 draws its shard (heads, kv heads, d_ff of every
    layer; the projector, embed, norms and the odd-vocab head whole),
    equal bit for bit to ``shard_params`` of the whole draw."""
    cfg = treg.get_config(ARCH).with_(num_layers=2, num_instances=2, d_model=64, d_ff=96,
                                      num_heads=4, num_kv_heads=2, vocab_size=101,
                                      num_image_patches=4, vision_embed_dim=48)
    cpu = torch.device("cpu")
    whole = serve.random_merged(cfg, 3, cpu)[0]
    assert shardings.layers_split(cfg, 2) and not shardings.vocab_split(cfg, 2)
    for rank in range(2):
        got = serve.random_merged(cfg, 3, cpu, cut=shardings.vlm_cut(cfg, rank, 2))[0].tree()
        want = shardings.shard_params(cfg, whole, rank, 2).tree()
        for k, v in want["layers"].items():
            assert torch.equal(got["layers"][k], v), (rank, k)
            split = k in shardings.LAYER_SPLIT_DIM
            assert (v.numel() * 2 == whole["layers"][k].numel()) == split, k
        for k, v in want["projector"].items():
            assert torch.equal(got["projector"][k], v) and torch.equal(v, whole["projector"][k])
        for k in ("embed", "final_norm", "lm_head"):
            assert torch.equal(got[k], want[k]) and torch.equal(got[k], whole[k]), (rank, k)


_RUNS = {}


def _setup():
    if not _RUNS:
        jcfg = jreg.get_smoke_config(ARCH).with_(num_instances=M)
        tcfg = treg.get_smoke_config(ARCH).with_(num_instances=M)
        jp = japi.init(jcfg, jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        reqs = [(i % M, rng.integers(1, jcfg.vocab_size, size=n).tolist(), 4 + i % 3)
                for i, n in enumerate((2, 3, 7, 12, 18))]
        srv = JServer(jcfg, jp, temperature=0.0, **SERVER_KW)
        for inst, prompt, n in reqs:
            srv.submit(JRequest(inst, list(prompt), n))
        _RUNS["want"] = {r.request_id: r.tokens for r in srv.run_until_drained()}
        _RUNS["setup"] = (tcfg, params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu"),
                          [Request(i, list(p), n) for i, p, n in reqs])
    return _RUNS["want"], _RUNS["setup"]


@pytest.mark.parametrize("t", MESHES, ids=[f"1x{t}" for t in MESHES])
def test_engine_streams_match_jax_single_device(t):
    """Every rank's greedy streams (K = 8) equal the JAX single-device
    engine's; the ranks made the same calls; 1x2 splits the layers, 1x4
    holds them whole."""
    want, (tcfg, tp, reqs) = _setup()
    assert want and all(want.values())
    assert shardings.layers_split(tcfg, t) == (t == 2)
    ranks = mesh.spawn(serve.serve_rank, t, tcfg, tp, reqs, SERVER_KW, device="cpu")
    for r in ranks:
        assert r["backend"] == "gloo" and r["streams"] == want
        assert (r["decode_blocks"], r["prefill_calls"]) == (ranks[0]["decode_blocks"],
                                                            ranks[0]["prefill_calls"])
        assert r["snapshot"]["mesh"] == {"shape": {"data": 1, "model": t}, "devices": t}
