"""The port's MoE family (``repro_torch.models.moe``) against
``repro.models.moe`` on the CPU, for olmoe-smoke and qwen3-moe-smoke.

Both packages get the same weights (``repro.api.init`` on JAX's CPU,
carried across with ``checkpoint.bridge.params_from_numpy``) and the
same numpy-seeded inputs, in f32.  Routing -- the top-k experts, the
sorted assignment stream, the keep / drop decisions and the carried
counts -- must be equal exactly; outputs, caches and logits within 1e-5
relative (1e-5 absolute floor): the port multiplies the kept rows only,
the reference zero-padded capacity buffers, so only summation order
differs.  Greedy serving streams must be equal to the JAX engine's.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from repro import api as japi
from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro_torch import api as tapi
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.models import moe as tmoe

ARCHS = ["olmoe-1b-7b", "qwen3-moe-30b-a3b"]
TOL = dict(rtol=1e-5, atol=1e-5)
M = 2


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _both(arch, **kw):
    jcfg = jreg.get_smoke_config(arch).with_(num_instances=M, **kw)
    tcfg = treg.get_smoke_config(arch).with_(num_instances=M, **kw)
    jparams = japi.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _layer(jp, tp, i=0):
    jl = {k: v[i] for k, v in jp["layers"].items()}
    tl = {k: tp["layers"][k][i] for k in ("router", "we_gate", "we_up", "we_down")}
    return jl, tl


def _np(x):
    return np.asarray(x, np.float32)


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)


def _jax_route(cfg, lp, x, cap, valid=None, counts=None, limit=None):
    """The reference's routing steps of ``moe_mlp`` (its own
    ``_sorted_keep``), for the exact comparison."""
    m, b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = jnp.einsum("mbsd,mde->mbse", x.astype(jnp.float32),
                        lp["router"].astype(jnp.float32))
    top_w, top_e = lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    e_flat = top_e.reshape(m, b, s * k)
    if valid is not None:
        v_flat = jnp.broadcast_to(valid[..., None], (m, b, s, k)).reshape(m, b, s * k)
        e_flat = jnp.where(v_flat, e_flat, e)
    order = jnp.argsort(e_flat, axis=-1)
    e_sorted = jnp.take_along_axis(e_flat, order, axis=-1)
    if counts is None:
        keep = jax.vmap(jax.vmap(lambda es: jmoe._sorted_keep(es, cap, e)[1]))(e_sorted)
    else:
        keep = jax.vmap(jax.vmap(lambda es, ct, lm: jmoe._sorted_keep(es, cap, e, ct, lm)[1]))(
            e_sorted, counts, limit)
    return {"top_e": top_e, "order": order, "e_sorted": e_sorted, "keep": keep}


def _assert_route(cfg, tl, jl, x, cap, **kw):
    tkw = {n: torch.from_numpy(np.array(v)) for n, v in kw.items()}
    got = tmoe.route(cfg, tl["router"], torch.from_numpy(x), cap=cap, **tkw)
    want = _jax_route(cfg, jl, jnp.asarray(x), cap, **{n: jnp.asarray(v) for n, v in kw.items()})
    for name in ("top_e", "order", "e_sorted", "keep"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    return got


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_exact_matches_reference(arch):
    """The exact-length form at the reference's capacity (some experts
    overflow it at S = 12): routing equal, outputs within 1e-5."""
    jcfg, tcfg, jp, tp = _both(arch)
    jl, tl = _layer(jp, tp)
    x = _x(jcfg, (M, 2, 12), 1)
    r = _assert_route(tcfg, tl, jl, x, tmoe.capacity(tcfg, 12))
    assert not r["keep"][r["e_sorted"] < tcfg.num_experts].all()   # some assignments drop
    want, _ = jmoe.moe_mlp(jcfg, jl, jnp.asarray(x))
    got = tmoe.moe_mlp(tcfg, tl, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert tmoe.capacity(tcfg, 12) == jmoe.capacity(jcfg, 12)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_chunked_routing_matches_exact(arch):
    """The twin of ``test_serving_chunked``'s: chained counts and the
    real-length capacity route (and drop, at capacity_factor 0.5) as one
    exact-length pass; each chunk's routing and counts equal the
    reference's chunked call."""
    jcfg, tcfg, jp, tp = _both(arch, capacity_factor=0.5)
    jl, tl = _layer(jp, tp)
    s = 12
    x = _x(jcfg, (M, 1, s), 2)
    exact = tmoe.moe_mlp(tcfg, tl, torch.from_numpy(x))
    np.testing.assert_allclose(exact.numpy(), _np(jmoe.moe_mlp(jcfg, jl, jnp.asarray(x))[0]),
                               **TOL)
    limit = np.full((M, 1), tmoe.capacity(tcfg, s), np.int32)
    tcounts = torch.zeros(M, 1, tcfg.num_experts, dtype=torch.int32)
    jcounts = jnp.zeros((M, 1, jcfg.num_experts), jnp.int32)
    outs, dropped = [], 0
    for i in range(0, s, 4):
        xc = x[:, :, i:i + 4]
        r = _assert_route(tcfg, tl, jl, xc, 4 * tcfg.num_experts_per_tok,
                          counts=np.asarray(jcounts), limit=limit)
        dropped += int((~r["keep"]).sum())
        y, tcounts = tmoe.moe_mlp(tcfg, tl, torch.from_numpy(xc), counts=tcounts,
                                  limit=torch.from_numpy(limit))
        jy, _, jcounts = jmoe.moe_mlp(jcfg, jl, jnp.asarray(xc), counts=jcounts,
                                      limit=jnp.asarray(limit))
        np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
        np.testing.assert_allclose(y.numpy(), _np(jy), **TOL)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 2).numpy(), exact.numpy(), **TOL)
    assert dropped > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_validity_mask_matches_unpadded(arch):
    """The twin of ``test_serving_chunked``'s: masked tokens take no
    capacity, shift no position, output zeros and advance no count."""
    jcfg, tcfg, jp, tp = _both(arch, capacity_factor=0.5)
    jl, tl = _layer(jp, tp)
    s_real, s_pad = 8, 12
    x = _x(jcfg, (M, 1, s_pad), 3)
    limit = np.full((M, 1), tmoe.capacity(tcfg, s_real), np.int32)
    counts = np.zeros((M, 1, tcfg.num_experts), np.int32)
    valid = np.broadcast_to(np.arange(s_pad) < s_real, (M, 1, s_pad)).copy()
    _assert_route(tcfg, tl, jl, x, s_pad * tcfg.num_experts_per_tok, valid=valid,
                  counts=counts, limit=limit)
    t = {n: torch.from_numpy(v) for n, v in
         dict(x=x, valid=valid, counts=counts, limit=limit).items()}
    padded, new_counts = tmoe.moe_mlp(tcfg, tl, t["x"], valid=t["valid"], counts=t["counts"],
                                      limit=t["limit"])
    exact, _ = tmoe.moe_mlp(tcfg, tl, t["x"][:, :, :s_real], counts=t["counts"],
                            limit=t["limit"])
    want, _, jcounts = jmoe.moe_mlp(jcfg, jl, jnp.asarray(x), valid=jnp.asarray(valid),
                                    counts=jnp.asarray(counts), limit=jnp.asarray(limit))
    np.testing.assert_allclose(padded.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(padded[:, :, :s_real].numpy(), exact.numpy(), **TOL)
    assert padded[:, :, s_real:].eq(0).all()
    np.testing.assert_array_equal(new_counts.numpy(), np.asarray(jcounts))
    assert int(new_counts.sum()) == M * s_real * tcfg.num_experts_per_tok


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_then_decode_logits_match(arch):
    """Three chunks of 8 with the last padded past the prompt (tail
    folding) and the exact-length limit: the caches and the per-layer
    counts agree; then a decode step's logits and greedy tokens."""
    jcfg, tcfg, jp, tp = _both(arch)
    ctx, c, plen = 40, 8, 21
    toks = np.random.default_rng(4).integers(1, jcfg.vocab_size, (M, 1, 24)).astype(np.int32)
    limit = np.full((M, 1), tmoe.capacity(tcfg, plen), np.int32)
    jcarry = japi.init_chunk_carry(jcfg, M, 1, ctx)
    tcarry = tapi.init_chunk_carry(tcfg, M, 1, ctx, device="cpu")
    for start in range(0, 24, c):
        chunk = toks[:, :, start:start + c]
        valid = (start + np.arange(c) < plen)[None, None].repeat(M, 0)
        off = np.full((M, 1), start, np.int32)
        jcarry = japi.prefill_chunk(
            jcfg, jp, {"tokens": jnp.asarray(chunk), "valid": jnp.asarray(valid),
                       "moe_limit": jnp.asarray(limit)}, jcarry, jnp.asarray(off))
        tapi.prefill_chunk(tcfg, tp, {"tokens": torch.from_numpy(chunk),
                                      "valid": torch.from_numpy(valid),
                                      "moe_limit": torch.from_numpy(limit)},
                           tcarry, torch.from_numpy(off))
    for g, w in zip(tcarry["cache"], jcarry["cache"]):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)
    np.testing.assert_array_equal(tcarry["counts"].numpy(), np.asarray(jcarry["counts"]))
    assert not tcarry["cache"].k[:, :, :, plen:].any()

    tok = toks[:, :, plen - 1:plen]
    pos = np.full((M, 1), plen - 1, np.int32)
    jlog, _ = japi.decode_step(jcfg, jp, jcarry["cache"], jnp.asarray(tok), jnp.asarray(pos))
    cache = tcarry["cache"]
    tlog, _ = tapi.decode_step(tcfg, tp, type(cache)(cache.k.clone(), cache.v.clone()),
                               torch.from_numpy(tok), torch.from_numpy(pos))
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), **TOL)
    nxt, _ = tapi.decode_step_sample(tcfg, tp, cache, torch.from_numpy(tok),
                                     torch.from_numpy(pos))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnp.argmax(jlog, axis=-1)))


@pytest.mark.parametrize("k", [1, 8])
def test_engine_streams_match_jax_engine(k):
    """The olmoe case of ``test_serving_chunked``'s ``FAMILY_CASES``
    (smoke config, M = 2, 2 slots, context 64, chunk 5 over 3 lanes,
    prompts of 1-18 tokens) plus budgets that end lanes mid-block at K =
    8: greedy streams and device-call counts equal the JAX engine's."""
    from repro.serving import MultiModelServer as JServer
    from repro.serving import Request as JRequest
    from repro_torch.serving import MultiModelServer, Request

    jcfg, tcfg, jp, tp = _both("olmoe-1b-7b")
    rng = np.random.default_rng(0)
    reqs = [(i % 2, rng.integers(1, jcfg.vocab_size, size=n).tolist(), 4 + i % 3)
            for i, n in enumerate((1, 3, 7, 12, 18))]
    kw = dict(slots_per_instance=2, max_context=64, temperature=0.0, prefill_chunk=5,
              prefill_lanes=3, chunk_budget=2, decode_steps=k)

    def drain(srv, req_cls):
        for inst, prompt, n in reqs:
            srv.submit(req_cls(inst, list(prompt), n))
        out = {r.request_id: r.tokens for r in srv.run_until_drained()}
        return out, srv.steps, srv.prefill.device_calls

    want = drain(JServer(jcfg, jp, **kw), JRequest)
    got = drain(MultiModelServer(tcfg, tp, device="cpu", **kw), Request)
    assert len(want[0]) == len(reqs) and all(want[0].values()) and got == want


def test_init_storage_dtypes_and_refusals():
    """``init`` draws the reference's tree in the storage dtypes (expert
    and attention weights in the activation dtype, router, norms, embed
    and lm_head in param_dtype); on a mesh the cache holds the rank's kv
    heads."""
    cfg = treg.get_config("olmoe-1b-7b").with_(num_layers=1, num_instances=1, d_model=64,
                                               d_ff=32, num_heads=2, num_kv_heads=2,
                                               vocab_size=128, num_experts=8)
    p = tapi.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.eval_shape(lambda: japi.init(jreg.get_config("olmoe-1b-7b").with_(
        num_layers=1, d_model=64, d_ff=32, num_heads=2, num_kv_heads=2, vocab_size=128,
        num_experts=8), jax.random.PRNGKey(0)))
    tree = p.tree()
    for name, leaf in want["layers"].items():
        got = tree["layers"][name]
        assert tuple(got.shape) == leaf.shape, name
        assert got.dtype == (torch.bfloat16 if name in tmoe.MATMUL_LEAVES else torch.float32)
    assert tree["lm_head"].shape == want["lm_head"].shape
    assert tree["layers"]["we_gate"].float().std().item() == pytest.approx(64 ** -0.5, rel=0.1)
    # on a mesh a rank's cache holds its kv heads ("kv" over 2 ranks); the
    # audio family still refuses tensor parallelism
    two = SimpleNamespace(rank=1, size=2)
    assert tapi.make_cache(cfg, 1, 1, 8, device="cpu", tp=two).k.shape[4] == 1
    with pytest.raises(NotImplementedError, match="dense, moe, ssm, hybrid and vlm"):
        tapi.make_cache(treg.get_smoke_config("whisper-small"), 1, 1, 8, device="cpu",
                        tp=object())
