"""Merged MoE on a (data=D, model=T) mesh (``repro_torch.models.moe`` under
``tp``, ``models/shardings.py``'s moe rules) against ``repro.models.moe``
on the CPU, olmoe-smoke and qwen3-moe-smoke in f32.

* The expert window: each rank's partial from the windowed ``moe_mlp``
  (``ltp`` with the sum left out) equals the reference's
  ``_row_dispatch_window`` -> expert einsums -> ``_row_combine`` for that
  window, the body of its ``_moe_mlp_ep_shmap``, called here as pure
  functions (no mesh), within 1e-5; the plain and the chunked (counts,
  limit, valid) forms at T in {2, 4}.  The partials sum to the
  reference's single-device ``moe_mlp`` within 1e-5.  (The reference's
  own moe mesh tests fail on this JAX, so its mesh path is not the
  yardstick.)
* The sliced draw: a rank's shard drawn layer by layer
  (``launch/serve.random_merged`` with ``shardings.moe_cut``) equals the
  whole draw's slice bit for bit.
* The engine on 1x2, 2x1 and 2x2 gloo meshes (``mesh.spawn``, one spawn
  per mesh shape): greedy streams equal the JAX single-device engine's,
  tokens exact; a chunked prefill plus decode step on the same ranks
  gives logits within 1e-4 of the reference's.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import api as japi
from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro.serving import MultiModelServer as JServer
from repro.serving import Request as JRequest
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.launch import mesh, serve, tp_parity
from repro_torch.models import moe as tmoe
from repro_torch.models import shardings
from repro_torch.serving import Request

ARCHS = ["olmoe-1b-7b", "qwen3-moe-30b-a3b"]
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
M = 2


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_PARAMS = {}


def _both(arch, **kw):
    key = (arch, tuple(sorted(kw.items())))
    if key not in _PARAMS:
        jcfg = jreg.get_smoke_config(arch).with_(num_instances=M, **kw)
        tcfg = treg.get_smoke_config(arch).with_(num_instances=M, **kw)
        jp = japi.init(jcfg, jax.random.PRNGKey(0))
        _PARAMS[key] = (jcfg, tcfg, jp,
                        params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu"))
    return _PARAMS[key]


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# the expert window against the reference's pure row functions
# ---------------------------------------------------------------------------


def _ref_window(cfg, lp, x, rank, n, valid=None, counts=None, limit=None):
    """Rank ``rank``'s partial, the body of the reference's
    ``_moe_mlp_ep_shmap`` without its psum: the whole routing of
    ``moe_mlp``, ``_row_dispatch_window`` into the window's capacity
    buffers, the window's expert einsums, ``_row_combine``."""
    m, b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = s * k if counts is not None else jmoe.capacity(cfg, s)
    probs = jax.nn.softmax(jnp.einsum("mbsd,mde->mbse", x, lp["router"]), axis=-1)
    top_w, top_e = lax.top_k(probs, k)
    top_w = top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)
    e_flat, w_flat = top_e.reshape(m, b, s * k), top_w.reshape(m, b, s * k)
    if valid is not None:
        v_flat = jnp.broadcast_to(valid[..., None], (m, b, s, k)).reshape(m, b, s * k)
        e_flat = jnp.where(v_flat, e_flat, e)
    order = jnp.argsort(e_flat, axis=-1).astype(jnp.int32)
    e_sorted = jnp.take_along_axis(e_flat, order, axis=-1)
    w_sorted = jnp.take_along_axis(w_flat, order, axis=-1)
    if counts is None:      # the reference's neutral chunked extras
        counts = jnp.zeros((m, b, e), jnp.int32)
        limit = jnp.full((m, b), jnp.iinfo(jnp.int32).max, jnp.int32)
    e_l = e // n
    lo = rank * e_l
    buf, dest, local, tok = jax.vmap(jax.vmap(
        lambda xr, es, od, ct, lm: jmoe._row_dispatch_window(xr, es, od, cap, e, lo, e_l,
                                                            counts=ct, limit=lm)))(
        x, e_sorted, order, counts, limit)
    buf = buf.reshape(m, b, e_l, cap, d)
    w = {n_: lp[n_][:, lo:lo + e_l] for n_ in ("we_gate", "we_up", "we_down")}
    h = jax.nn.silu(jnp.einsum("mbecd,medf->mbecf", buf, w["we_gate"]))
    h = h * jnp.einsum("mbecd,medf->mbecf", buf, w["we_up"])
    y = jnp.einsum("mbecf,mefd->mbecd", h, w["we_down"]).reshape(m, b, e_l * cap, d)
    combine = jax.vmap(jax.vmap(
        lambda yb, de, ke, ts, ww: jmoe._row_combine(yb, de, ke, ts, ww, s)))
    return combine(y, dest, local, tok, w_sorted)


def _window(tl, rank, n):
    e_l = tl["we_gate"].shape[1] // n
    return {k: (v if k == "router" else v[:, rank * e_l:(rank + 1) * e_l].contiguous())
            for k, v in tl.items()}


@pytest.mark.parametrize("form", ["plain", "chunked"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_window_partials_match_reference(arch, n, form):
    jcfg, tcfg, jp, tp = _both(arch, capacity_factor=0.5)
    jl = {k: v[1] for k, v in jp["layers"].items()}
    tl = {k: tp["layers"][k][1] for k in ("router", "we_gate", "we_up", "we_down")}
    s = 12
    x = _x(jcfg, (M, 2, s), 11)
    kw, tkw = {}, {}
    if form == "chunked":
        rng = np.random.default_rng(12)
        valid = np.arange(s)[None, None] < np.array([[9, 12], [12, 5]])[..., None]
        counts = rng.integers(0, 4, (M, 2, jcfg.num_experts)).astype(np.int32)
        limit = np.array([[7, 9], [11, 6]], np.int32)
        kw = dict(valid=valid, counts=counts, limit=limit)
        tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    tx = torch.from_numpy(x)
    parts = []
    for r in range(n):
        ltp = SimpleNamespace(rank=r, size=n, all_reduce_sum=lambda t: t)
        got = tmoe.moe_mlp(tcfg, _window(tl, r, n), tx, ltp=ltp, **tkw)
        got = got[0] if form == "chunked" else got
        want = _ref_window(jcfg, jl, jnp.asarray(x), r, n,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"rank {r}")
        parts.append(got)
    whole = jmoe.moe_mlp(jcfg, jl, jnp.asarray(x), **{k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_allclose(sum(parts).numpy(), np.asarray(whole[0]), **TOL)
    if form == "chunked":
        # every rank routes in full: its counts are the single device's
        ltp = SimpleNamespace(rank=0, size=n, all_reduce_sum=lambda t: t)
        counts = tmoe.moe_mlp(tcfg, _window(tl, 0, n), tx, ltp=ltp, **tkw)[1]
        np.testing.assert_array_equal(counts.numpy(), np.asarray(whole[2]))


def test_moe_rules_split_each_part_apart():
    """The attention splits as dense's where the head plan is "kv", the
    experts where E divides, lm_head where V divides; the router, the
    norms and the embedding stay whole.  Shards tile the whole."""
    cfg = treg.get_smoke_config("qwen3-moe-30b-a3b").with_(num_instances=M, vocab_size=256)
    p = tmoe.init(cfg, torch.Generator().manual_seed(0), "cpu")
    lay = p["layers"]
    for n, attn, experts in ((2, True, True), (4, False, True), (3, False, False)):
        assert shardings.attn_split(cfg, n) is attn and shardings.expert_split(cfg, n) is experts
        shards = [shardings.shard_params(cfg, p, r, n) for r in range(n)]
        for k in ("router", "attn_norm", "mlp_norm"):
            assert all(s_["layers"][k].data_ptr() == lay[k].data_ptr() for s_ in shards), k
        for k, dim in (("wq", 3), ("wk", 3), ("wo", 2), ("we_gate", 2), ("we_down", 2)):
            split = attn if k.startswith("w") and not k.startswith("we") else experts
            got = [s_["layers"][k] for s_ in shards]
            if split:
                assert torch.equal(torch.cat(got, dim), lay[k]), (n, k)
            else:
                assert all(g.data_ptr() == lay[k].data_ptr() for g in got), (n, k)
        heads = torch.cat([s_["lm_head"] for s_ in shards], 2) if n != 3 else shards[0]["lm_head"]
        assert torch.equal(heads, p["lm_head"]) and shards[0]["embed"] is not None
        assert shardings.local_kv_heads(cfg, n) == (1 if attn else cfg.num_kv_heads)


# ---------------------------------------------------------------------------
# a rank draws only its shard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,t", [(1, 2), (2, 2), (1, 4)])
def test_rank_draw_equals_the_whole_draws_slice(d, t):
    """``random_merged`` with ``moe_cut``: every rank's shard, drawn layer
    by layer, equals the whole draw's slice bit for bit; the whole
    in-place draw equals M one-instance draws merged."""
    cfg = treg.get_smoke_config("olmoe-1b-7b").with_(num_instances=4, num_experts=8)
    cpu = torch.device("cpu")
    whole = serve.random_merged(cfg, 3, cpu)[0]
    one = cfg.with_(num_instances=1)
    from repro_torch.models.common import merge_drawn
    merged = merge_drawn(lambda j: tmoe.init(one, torch.Generator().manual_seed(3000 + j), cpu),
                         4)
    for k, v in whole.tree()["layers"].items():
        assert torch.equal(v, merged["layers"][k]), k
    assert torch.equal(whole["lm_head"], merged["lm_head"])
    for g in range(d * t):
        data, rank = SimpleNamespace(rank=g // t, size=d), g % t
        rows = shardings.data_rows(4, 2, data)
        local = cfg.with_(num_instances=rows.m)
        got = serve.random_merged(cfg, 3, cpu, rows=range(rows.m0, rows.m0 + rows.m),
                                  cut=shardings.moe_cut(local, rank, t))[0].tree()
        want = shardings.shard_params(local, shardings.data_params(whole, rows), rank, t).tree()
        for k, v in want["layers"].items():
            assert torch.equal(got["layers"][k], v), (g, k)
        for k in ("embed", "final_norm", "lm_head"):
            assert torch.equal(got[k], want[k]), (g, k)


# ---------------------------------------------------------------------------
# the engine on 1x2, 2x1 and 2x2 gloo meshes against the JAX engine
# ---------------------------------------------------------------------------

SERVER_KW = dict(slots_per_instance=2, max_context=64, prefill_chunk=5, prefill_lanes=3,
                 chunk_budget=2)
MESHES = [(1, 2), (2, 1), (2, 2)]
CHUNK_TOKENS = (M, 2, 13)         # the chunked prefill + decode: 3 chunks of 5, tail 3


def _requests(req_cls, cfg):
    rng = np.random.default_rng(0)
    return [req_cls(i % M, rng.integers(1, cfg.vocab_size, size=n).tolist(), 4 + i % 3)
            for i, n in enumerate((1, 3, 7, 12, 18))]


_RUNS = {}


def _jax_streams(arch):
    if arch not in _RUNS:
        jcfg, _, jp, _ = _both(arch)
        srv = JServer(jcfg, jp, temperature=0.0, decode_steps=8, **SERVER_KW)
        for r in _requests(JRequest, jcfg):
            srv.submit(r)
        _RUNS[arch] = {r.request_id: r.tokens for r in srv.run_until_drained()}
    return _RUNS[arch]


def _tokens(cfg):
    return torch.from_numpy(np.random.default_rng(7).integers(
        1, cfg.vocab_size, CHUNK_TOKENS).astype(np.int32))


def _jax_chunk_decode(arch):
    """The reference's chunked prefill of ``_tokens`` at the exact-length
    capacity, then its decode step's logits at position n."""
    if ("chunk", arch) in _RUNS:
        return _RUNS["chunk", arch]
    jcfg, tcfg, jp, _ = _both(arch)
    toks = _tokens(tcfg).numpy()
    m, b, n = toks.shape
    limit = jnp.full((m, b), jmoe.capacity(jcfg, n), jnp.int32)
    carry = japi.init_chunk_carry(jcfg, m, b, 32)
    prefill = jax.jit(japi.prefill_chunk, static_argnums=0)
    for start in range(0, n, 5):
        carry = prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :, start:start + 5]),
                                   "moe_limit": limit}, carry, jnp.full((m, b), start, jnp.int32))
    logits, _ = japi.decode_step(jcfg, jp, carry["cache"], jnp.asarray(toks[:, :, -1:]),
                                 jnp.full((m, b), n, jnp.int32))
    _RUNS["chunk", arch] = np.asarray(logits)
    return _RUNS["chunk", arch]


def _mesh_runs(d, t):
    """Per rank, in one spawn: each arch's serve (K = 8) and its chunked
    prefill + decode step."""
    if (d, t) not in _RUNS:
        calls, keys = [], []
        for arch in ARCHS:
            _, tcfg, _, tp = _both(arch)
            calls.append((serve.serve_rank, tcfg, tp, _requests(Request, tcfg),
                          dict(SERVER_KW, decode_steps=8)))
            calls.append((tp_parity.chunk_decode_rank, tcfg, tp, _tokens(tcfg), 5, 32))
            keys += [("serve", arch), ("chunk", arch)]
        ranks = mesh.spawn(mesh.in_turn, t, *calls, device="cpu", data=d)
        _RUNS[d, t] = [dict(zip(keys, r)) for r in ranks]
    return _RUNS[d, t]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("d,t", MESHES, ids=[f"{d}x{t}" for d, t in MESHES])
def test_engine_streams_match_jax_single_device(d, t, arch):
    """Every rank's greedy streams equal the JAX single-device engine's
    (the expert windows, the heads and the vocab split over "model", the
    instance rows over "data"); the ranks made the same calls."""
    want = _jax_streams(arch)
    assert want and all(want.values())
    runs = [r["serve", arch] for r in _mesh_runs(d, t)]
    for r in runs:
        assert r["backend"] == "gloo" and r["streams"] == want
        assert (r["decode_blocks"], r["prefill_calls"]) == (runs[0]["decode_blocks"],
                                                            runs[0]["prefill_calls"])
        assert r["snapshot"]["mesh"] == {"shape": {"data": d, "model": t}, "devices": d * t}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("d,t", MESHES, ids=[f"{d}x{t}" for d, t in MESHES])
def test_chunk_decode_logits_match_jax(d, t, arch):
    """A chunked prefill and a decode step on the ranks: logits (gathered
    over the vocab split) within 1e-4 of the reference's, greedy tokens
    their argmax, on every rank."""
    want = _jax_chunk_decode(arch)
    for r in _mesh_runs(d, t):
        got = r["chunk", arch]
        np.testing.assert_allclose(got["logits"].numpy(), want, **LOGIT_TOL)
        np.testing.assert_array_equal(got["tokens"].numpy(), want.argmax(-1))
