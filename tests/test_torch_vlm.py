"""The port's vlm family (``repro_torch.models.vlm``, internvl2-26b) against
``repro.models.vlm`` on the CPU, internvl2-smoke in f32.

Both packages get the same weights (``repro.api.init`` on JAX's CPU,
carried across with ``checkpoint.bridge.params_from_numpy``) and the same
numpy-seeded inputs.  The projector and a chunked prefill over the image
prefix and the prompt (random patch embeddings, a chunk straddling the
prefix, a padded tail) must give caches within 1e-4 of the reference's
(f32; only summation order differs), lanes reading other instances'
weights too; a decode step's logits within 1e-4; and the engine's greedy
streams must equal the JAX engine's on the reference's case of
``tests/test_serving_chunked.py`` (zero patch embeddings, as both
engines serve them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import registry as jreg
from repro.models import vlm as jvlm
from repro.serving import MultiModelServer as JServer
from repro.serving import Request as JRequest
from repro_torch import api as tapi
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch.models import vlm as tvlm
from repro_torch.models.common import merge_drawn
from repro_torch.serving import MultiModelServer, Request

ARCH = "internvl2-26b"
TOL = dict(rtol=1e-4, atol=1e-4)
M = 2


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_P = {}


def _both():
    if not _P:
        jcfg = jreg.get_smoke_config(ARCH).with_(num_instances=M)
        tcfg = treg.get_smoke_config(ARCH).with_(num_instances=M)
        jp = japi.init(jcfg, jax.random.PRNGKey(0))
        _P["v"] = (jcfg, tcfg, jp, params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu"))
    return _P["v"]


def _gathered(jp, idx):
    """The reference's tree with instance rows ``idx`` (per lane)."""
    return {k: ({n: (v[:, idx] if k == "layers" else v[idx]) for n, v in sub.items()}
                if isinstance(sub, dict) else sub[idx]) for k, sub in jp.items()}


def test_project_image_matches_reference():
    jcfg, tcfg, jp, tp = _both()
    img = np.random.default_rng(1).standard_normal(
        (M, 2, jcfg.num_image_patches, jcfg.vision_embed_dim)).astype(np.float32)
    want = jvlm.project_image(jcfg, jp, jnp.asarray(img))
    got = tvlm.project_image(tcfg, tp, torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("lanes", [None, [1, 0, 1]], ids=["own", "lane_groups"])
def test_prefill_chunk_then_decode_match_reference(lanes):
    """Chunks of 5 over 8 patch positions and a 9-token prompt (a chunk
    straddles the prefix; the last is padded past the prompt, ``valid``
    False there): caches within 1e-4; then a decode step's logits and
    greedy tokens.  ``lane_groups``: three lanes reading instances 1, 0, 1
    through ``instances=``, against the reference on those rows."""
    jcfg, tcfg, jp, tp = _both()
    p, n_tok, c, ctx = jcfg.num_image_patches, 9, 5, 32
    total = p + n_tok
    m = M if lanes is None else len(lanes)
    rng = np.random.default_rng(2)
    img = rng.standard_normal((m, 1, p, jcfg.vision_embed_dim)).astype(np.float32)
    toks = rng.integers(1, jcfg.vocab_size, (m, 1, 20)).astype(np.int32)
    jref = jp if lanes is None else _gathered(jp, np.array(lanes))
    jcfg_l = jcfg.with_(num_instances=m)
    jcarry = japi.init_chunk_carry(jcfg_l, m, 1, ctx)
    jprefill = jax.jit(japi.prefill_chunk, static_argnums=0)
    tcarry = tapi.init_chunk_carry(tcfg.with_(num_instances=m), m, 1, ctx, device="cpu")
    for start in range(0, 20, c):
        chunk = np.zeros((m, 1, c), np.int32)
        pos = start + np.arange(c)
        chunk[..., pos >= p] = toks[..., pos[pos >= p] - p]
        valid = np.broadcast_to(pos < total, (m, 1, c)).copy()
        off = np.full((m, 1), start, np.int32)
        jcarry = jprefill(jcfg_l, jref, {"tokens": jnp.asarray(chunk),
                                         "image_embeds": jnp.asarray(img),
                                         "valid": jnp.asarray(valid)},
                          jcarry, jnp.asarray(off))
        tapi.prefill_chunk(tcfg, tp, {"tokens": torch.from_numpy(chunk),
                                      "image_embeds": torch.from_numpy(img),
                                      "valid": torch.from_numpy(valid)},
                           tcarry, torch.from_numpy(off), instances=lanes)
    for g, w in zip(tcarry["cache"], jcarry["cache"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert not tcarry["cache"].k[:, :, :, total:].any()
    if lanes is not None:
        return
    tok = toks[:, :, n_tok - 1:n_tok]
    pos = np.full((m, 1), total - 1, np.int32)
    jlog, _ = japi.decode_step(jcfg, jp, jcarry["cache"], jnp.asarray(tok), jnp.asarray(pos))
    cache = tcarry["cache"]
    tlog, _ = tapi.decode_step(tcfg, tp, type(cache)(cache.k.clone(), cache.v.clone()),
                               torch.from_numpy(tok), torch.from_numpy(pos))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    nxt, _ = tapi.decode_step_sample(tcfg, tp, cache, torch.from_numpy(tok),
                                     torch.from_numpy(pos))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnp.argmax(jlog, axis=-1)))


@pytest.mark.parametrize("k", [1, 8])
def test_engine_streams_match_jax_engine(k):
    """The internvl2 case of ``test_serving_chunked``'s ``FAMILY_CASES``
    (smoke config, M = 2, 2 slots, context 64, chunk 5 over 3 lanes,
    prompts of 2-18 tokens after the 8 patch positions) at K = 1 and 8:
    greedy streams and chunk-call counts equal the JAX engine's."""
    jcfg, tcfg, jp, tp = _both()
    rng = np.random.default_rng(0)
    reqs = [(i % 2, rng.integers(1, jcfg.vocab_size, size=n).tolist(), 4 + i % 3)
            for i, n in enumerate((2, 3, 7, 12, 18))]
    kw = dict(slots_per_instance=2, max_context=64, temperature=0.0, prefill_chunk=5,
              prefill_lanes=3, chunk_budget=2, decode_steps=k)

    def drain(srv, req_cls):
        for inst, prompt, n in reqs:
            srv.submit(req_cls(inst, list(prompt), n))
        out = {r.request_id: r.tokens for r in srv.run_until_drained()}
        return out, srv.prefill.device_calls

    want = drain(JServer(jcfg, jp, **kw), JRequest)
    got = drain(MultiModelServer(tcfg, tp, device="cpu", **kw), Request)
    assert len(want[0]) == len(reqs) and all(want[0].values()) and got == want


def test_init_draws_in_place_and_storage_dtypes():
    """``random_merged`` draws the merged model in place, equal bit for bit
    to one-instance draws merged; the projector's matmul leaves in the
    activation dtype, its norm (and embed, the norms, lm_head) in
    param_dtype; the tree's shapes are the reference's."""
    cfg = treg.get_config(ARCH).with_(num_layers=1, num_instances=2, d_model=64, d_ff=96,
                                      num_heads=4, num_kv_heads=2, vocab_size=101,
                                      num_image_patches=4, vision_embed_dim=48)
    cpu = torch.device("cpu")
    whole = serve.random_merged(cfg, 5, cpu)[0]
    one = cfg.with_(num_instances=1)
    merged = merge_drawn(lambda j: tvlm.init(one, torch.Generator().manual_seed(5000 + j), cpu),
                         2)
    want = jax.eval_shape(lambda: japi.init(jreg.get_config(ARCH).with_(
        num_layers=1, num_instances=2, d_model=64, d_ff=96, num_heads=4, num_kv_heads=2,
        vocab_size=101, num_image_patches=4, vision_embed_dim=48), jax.random.PRNGKey(0)))
    tree, ref = whole.tree(), merged.tree()
    for group in ("layers", "projector"):
        for name, leaf in want[group].items():
            got = tree[group][name]
            assert tuple(got.shape) == leaf.shape and torch.equal(got, ref[group][name]), name
    assert tree["projector"]["w1"].dtype == torch.bfloat16
    assert tree["projector"]["norm"].dtype == tree["embed"].dtype == torch.float32
    assert tree["projector"]["w1"].float().std().item() == pytest.approx(48 ** -0.5, rel=0.1)
    assert torch.equal(tree["lm_head"], ref["lm_head"])
