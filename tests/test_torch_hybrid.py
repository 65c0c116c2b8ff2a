"""The port's Hymba (hybrid family) against ``repro.models.hybrid`` on the CPU.

Both packages get the same weights: ``repro.api.init`` on JAX's CPU,
carried across with ``checkpoint.bridge.params_from_numpy``.  The JAX
side runs its XLA path (``use_pallas_kernels=False``), never Pallas
interpret mode.  hymba-smoke with 4 layers (global {0, 2, 3}, SWA {1}:
at 2 layers every layer is global), M=2, f32.  Prompts cross the 128
meta positions and wrap the 32-slot SWA ring.  Tolerance 1e-5 relative
and absolute for each module: both sides compute in f32 with the same
rounding points, and what is left is summation order (XLA's vs torch's
matmuls, cumsum, the SSD chunk scan), a few ulps.  The whole 4-layer
chain is held at 5e-5: each block adds ~5e-6 of such noise (its mamba
branch ~2e-6 before the branch norm), and the residual stream carries it
through the layers.  The reference itself moves by 1.2e-5 in the last
layer's cache when the same prompts are chunked by 8 instead of 16.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as japi
from repro.configs import registry as jreg
from repro.kernels import ref
from repro.models import hybrid as jhyb
from repro_torch import api as tapi
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops
from repro_torch.models import common as C
from repro_torch.models import hybrid as thyb
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_CHAIN = dict(rtol=5e-5, atol=5e-5)
# bf16 outputs: both sides compute in f32 from the same bf16 inputs and
# round once to bf16; a changed f32 summation order can flip that
# rounding by one bf16 ulp (2^-8 relative)
TOL_BF16 = dict(rtol=2 ** -8, atol=2 ** -8)
M = 2
R = thyb.NUM_META_TOKENS
CONTEXT = 256


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_BOTH = {}


def _both():
    if not _BOTH:
        jcfg = jreg.get_smoke_config("hymba-1.5b").with_(num_instances=M, num_layers=4)
        tcfg = treg.get_smoke_config("hymba-1.5b").with_(num_instances=M, num_layers=4)
        jp = japi.init(jcfg, jax.random.PRNGKey(0))
        _BOTH["v"] = (jcfg, tcfg, jp,
                      params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu"))
    return _BOTH["v"]


def _np(x):
    return np.asarray(x, np.float32)


def _jcache_leaves(cache):
    """The reference's cache leaves in the port's order: per group k, v;
    then the mamba h, conv."""
    out = []
    for kv in cache["kv"]:
        out += [kv.k, kv.v]
    return out + [cache["ssm"]["h"], cache["ssm"]["conv"]]


def _assert_cache(got, want):
    names = [f"kv[{i // 2}].{'kv'[i % 2]}" for i in range(2 * len(got["kv"]))] + [
        "ssm.h", "ssm.conv"]
    tl, jl = C._leaves(got), _jcache_leaves(want)
    assert len(tl) == len(jl) == len(names)
    for name, g, w in zip(names, tl, jl):
        np.testing.assert_allclose(g.float().numpy(), _np(w), err_msg=name, **TOL_CHAIN)


def _lane_inputs(jcfg, lengths, c, seed):
    """Token rows (M, 1, T) for prompts of the given lengths after the meta
    positions (ids there are ignored), T a multiple of the chunk c."""
    rng = np.random.default_rng(seed)
    total = R + max(lengths)
    t = -(-total // c) * c
    toks = rng.integers(1, jcfg.vocab_size, (M, 1, t)).astype(np.int32)
    return toks, [R + n for n in lengths]


def _prefill_both(jcfg, tcfg, jp, tp, toks, ends, c):
    """Chunk calls of width c over toks (M, 1, T), lane i valid up to
    position ends[i] (a padded final chunk where it ends mid-chunk)."""
    jcarry = japi.init_chunk_carry(jcfg, M, 1, CONTEXT)
    tcarry = tapi.init_chunk_carry(tcfg, M, 1, CONTEXT, device="cpu")
    jchunk = jax.jit(lambda p, b, cr, o: japi.prefill_chunk(jcfg, p, b, cr, o))
    for start in range(0, toks.shape[2], c):
        chunk = toks[:, :, start:start + c]
        valid = start + np.arange(c)[None, None] < np.asarray(ends)[:, None, None]
        off = np.full((M, 1), start, np.int32)
        jcarry = jchunk(jp, {"tokens": jnp.asarray(chunk), "valid": jnp.asarray(valid)},
                        jcarry, jnp.asarray(off))
        tapi.prefill_chunk(tcfg, tp, {"tokens": torch.from_numpy(chunk),
                                      "valid": torch.from_numpy(valid)},
                           tcarry, torch.from_numpy(off))
    return jcarry, tcarry


_CHAIN = {}


def _chain():
    """One prefill chain shared by the tests that read it: lane 0 holds
    178 positions (the SWA ring of 32 slots after the 128 meta tokens has
    wrapped), lane 1 stops mid-chunk at 170 (a padded final chunk)."""
    if not _CHAIN:
        jcfg, tcfg, jp, tp = _both()
        toks, ends = _lane_inputs(jcfg, [50, 42], 16, 0)
        jcarry, tcarry = _prefill_both(jcfg, tcfg, jp, tp, toks, ends, 16)
        _CHAIN["v"] = (toks, ends, jcarry, tcarry)
    return _CHAIN["v"]


def test_params_cross_the_bridge_with_storage_dtypes():
    jcfg, tcfg, jp, tp = _both()
    assert sorted(tp.keys()) == sorted(jp.keys())
    assert sorted(tp["layers"].keys()) == sorted(jp["layers"].keys())
    for k in ("meta_tokens", "embed", "lm_head"):
        np.testing.assert_array_equal(tp[k].numpy(), _np(jp[k]))
    for k, leaf in jp["layers"].items():
        np.testing.assert_array_equal(tp["layers"][k].numpy(), _np(leaf), err_msg=k)
    # full config: matmul, conv and skip leaves in cfg.dtype, the rest in param_dtype
    full = treg.get_config("hymba-1.5b")
    lay = {k: torch.zeros(1) for k in ("wq", "w_bc", "conv_w", "d_skip", "a_log",
                                       "b_dt", "norm")}
    got = thyb.storage_dtypes(full, {"layers": lay, "meta_tokens": torch.zeros(1),
                                     "lm_head": torch.zeros(1)})
    for k in ("wq", "w_bc", "conv_w", "d_skip"):
        assert got["layers"][k].dtype == torch.bfloat16, k
    for k in ("a_log", "b_dt", "norm"):
        assert got["layers"][k].dtype == torch.float32, k
    assert got["meta_tokens"].dtype == got["lm_head"].dtype == torch.float32


def test_config_helpers_match_reference():
    jcfg, tcfg, _, _ = _both()
    for cfg_j, cfg_t in ((jcfg, tcfg), (jreg.get_config("hymba-1.5b"),
                                        treg.get_config("hymba-1.5b"))):
        assert thyb.decode_groups(cfg_t) == jhyb.decode_groups(cfg_j)
        assert thyb.global_layers(cfg_t) == jhyb.global_layers(cfg_j)
        for fn in ("d_inner", "dt_rank", "ssm_heads", "swa_window", "min_serving_context"):
            assert getattr(thyb, fn)(cfg_t) == getattr(jhyb, fn)(cfg_j), fn
    assert thyb.ssm_heads(treg.get_config("hymba-1.5b")) == 50
    assert (thyb.NUM_META_TOKENS, thyb.GLOBAL_WINDOW) == (jhyb.NUM_META_TOKENS,
                                                          jhyb.GLOBAL_WINDOW)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kvh,s", [(4, 2, 16), (10, 2, 37), (5, 5, 130)])
def test_decode_attention_plain_matches_ref(dt, h, kvh, s):
    """G = 2, 5 (not a power of two) and 1; kv_len in {1, mid, S} across
    the lanes."""
    rng = np.random.default_rng(3)
    m, b, hd = 2, 3, 16
    q = rng.standard_normal((m, b, h, hd)).astype(np.float32)
    k = rng.standard_normal((m, b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((m, b, s, kvh, hd)).astype(np.float32)
    kv_len = np.array([[1, s // 2, s], [s, 2, s - 1]], np.int32)
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    want = ref.decode_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                jnp.asarray(kv_len))
    ops.reset_launches()
    got = ops.decode_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                               torch.from_numpy(kv_len))
    assert ops.launches()["decode_attention"] == 0          # CPU tensors: the plain version
    assert got.dtype == tdt and got.shape == (m, b, h, hd)
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               **(TOL if dt == "float32" else TOL_BF16))


@pytest.mark.parametrize("s_cache", [128 + 32, 128 + 20])
def test_swa_ring_visible_keys_are_the_decode_kernels_prefix(s_cache):
    """Decode attention of an SWA group: the ring's first min(pos + 1, S)
    slots (the decode-attention kernel's contract) are exactly the keys
    the reference's mask leaves visible -- the R pinned meta slots as the
    sink, the ring of S - R <= window slots over positions >= R -- before
    the ring fills, when it is full and after it wraps (S - R = 20 < the
    window of 32: a context below meta + window)."""
    cfg = treg.get_smoke_config("hymba-1.5b")
    r, w = thyb.NUM_META_TOKENS, thyb.swa_window(cfg)
    rng = np.random.default_rng(11)
    m, b, h, kvh, hd = 2, 3, 4, 2, 16
    pos = torch.tensor([[r, r + 7, s_cache - 1], [s_cache, s_cache + 13, 3 * s_cache]],
                       dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((m, b, h, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((m, b, s_cache, kvh, hd)).astype(np.float32))
            for _ in range(2))
    ring = L.cache_slot_positions(pos - r, s_cache - r)
    kv_pos = torch.cat([torch.arange(r, dtype=pos.dtype).expand(m, b, r),
                        torch.where(ring >= 0, ring + r, torch.full_like(ring, -1))], dim=-1)
    want = L.flash_attention_plain(q[:, :, None], k, v, pos[..., None], kv_pos, window=w,
                                   sink=r)[:, :, 0]
    got = ops.decode_attention(q, k, v, torch.clamp(pos + 1, max=s_cache))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_ssd_chunk_scan_matches_reference_with_state():
    rng = np.random.default_rng(4)
    m, b, s, h, hd, n = 2, 1, 12, 3, 4, 5
    u = rng.standard_normal((m, b, s, h, hd)).astype(np.float32)
    da = -np.abs(rng.standard_normal((m, b, s, h))).astype(np.float32)
    b_in, c_out = (rng.standard_normal((m, b, s, n)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((m, b, h, hd, n)).astype(np.float32)
    for chunk in (4, 64):                                   # 3 chunks, one chunk
        wy, wh = jhyb._ssd_chunk_scan(*(jnp.asarray(x) for x in (u, da, b_in, c_out, h0)),
                                      chunk=chunk)
        ty, th = thyb._ssd_chunk_scan(*(torch.from_numpy(x) for x in (u, da, b_in, c_out,
                                                                       h0)), chunk=chunk)
        np.testing.assert_allclose(ty.numpy(), _np(wy), **TOL)
        np.testing.assert_allclose(th.numpy(), _np(wh), **TOL)


@pytest.mark.parametrize("s,junk", [(6, True), (6, False), (1, False), (1, True)])
def test_mamba_branch_matches_reference(s, junk):
    """With a carried state: the chunk scan (S=6) and the one-step decode
    update (S=1); with junk steps, lane 1 turns junk after step 2 (S=6)
    or is junk altogether (S=1) and keeps its state bit for bit."""
    jcfg, tcfg, jp, tp = _both()
    rng = np.random.default_rng(5)
    d, di, n = jcfg.d_model, thyb.d_inner(tcfg), jcfg.ssm_state
    xn = rng.standard_normal((M, 1, s, d)).astype(np.float32)
    state = {"h": rng.standard_normal((M, 1, di, n)).astype(np.float32),
             "conv": rng.standard_normal((M, 1, jcfg.conv_kernel - 1, di)).astype(np.float32)}
    valid = None
    if junk:
        valid = np.ones((M, 1, s), bool)
        valid[1, 0, min(2, s - 1) if s > 1 else 0:] = False
    jlp = jax.tree.map(lambda t: t[1], jp["layers"])
    tlp = {k: tp["layers"][k][1] for k in tp["layers"].keys()}
    wy, wst = jhyb.mamba_branch(jcfg, jlp, jnp.asarray(xn),
                                state={k: jnp.asarray(v) for k, v in state.items()},
                                valid=None if valid is None else jnp.asarray(valid))
    ty, tst = thyb.mamba_branch(tcfg, tlp, torch.from_numpy(xn),
                                state={k: torch.from_numpy(v) for k, v in state.items()},
                                valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(ty.numpy(), _np(wy), **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(tst[k].numpy(), _np(wst[k]), err_msg=k, **TOL)
    if junk and s == 1:
        for k in ("h", "conv"):
            assert torch.equal(tst[k][1], torch.from_numpy(state[k][1])), k


def test_mamba_branch_without_state_matches_reference():
    jcfg, tcfg, jp, tp = _both()
    xn = np.random.default_rng(6).standard_normal((M, 1, 7, jcfg.d_model)).astype(np.float32)
    jlp = jax.tree.map(lambda t: t[0], jp["layers"])
    tlp = {k: tp["layers"][k][0] for k in tp["layers"].keys()}
    wy, wst = jhyb.mamba_branch(jcfg, jlp, jnp.asarray(xn))
    ty, tst = thyb.mamba_branch(tcfg, tlp, torch.from_numpy(xn))
    np.testing.assert_allclose(ty.numpy(), _np(wy), **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(tst[k].numpy(), _np(wst[k]), err_msg=k, **TOL)


def test_prefill_chain_across_meta_and_wrapped_ring_then_decode():
    """Chunks of 16 over the meta prefix and a prompt that wraps the SWA
    ring, lane 1 ending in a padded chunk; every cache leaf agrees, then
    two decode steps (logits and caches) and a greedy step."""
    jcfg, tcfg, jp, tp = _both()
    toks, ends, jcarry, tcarry = _chain()
    _assert_cache(tcarry["cache"], jcarry["cache"])

    jcache = jcarry["cache"]
    tcache = C.tree_map(lambda t: t.clone(), tcarry["cache"])
    jdecode = jax.jit(lambda p, c, t, ps: japi.decode_step(jcfg, p, c, t, ps))
    rng = np.random.default_rng(8)
    pos = np.asarray(ends, np.int32).reshape(M, 1)
    for step in range(2):
        tok = rng.integers(1, jcfg.vocab_size, (M, 1, 1)).astype(np.int32)
        jlogits, jcache = jdecode(jp, jcache, jnp.asarray(tok), jnp.asarray(pos + step))
        tlogits, tcache = tapi.decode_step(tcfg, tp, tcache, torch.from_numpy(tok),
                                           torch.from_numpy(pos + step))
        np.testing.assert_allclose(tlogits.numpy(), _np(jlogits), **TOL_CHAIN)
        _assert_cache(tcache, jcache)
    ttok, _ = tapi.decode_step_sample(tcfg, tp, tcache, torch.from_numpy(tok),
                                      torch.from_numpy(pos + 2))
    jlogits, _ = jdecode(jp, jcache, jnp.asarray(tok), jnp.asarray(pos + 2))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jnp.argmax(jlogits, -1)))


def test_padded_chunk_carry_equals_exact_length():
    """Within the port: the chain of ``_chain`` (lane 1's last chunk
    padded) leaves the cache of chunks that end exactly at each lane's
    length -- the junk rows never reach a ring and the mamba steps are
    neutral."""
    _, tcfg, _, tp = _both()
    toks, ends, _, tcarry = _chain()
    for lane in range(M):
        carry = tapi.init_chunk_carry(tcfg, 1, 1, CONTEXT, device="cpu")
        for start in range(0, ends[lane], 16):
            t = torch.from_numpy(toks[lane:lane + 1, :, start:min(start + 16, ends[lane])])
            tapi.prefill_chunk(tcfg, tp, {"tokens": t}, carry,
                               torch.full((1, 1), start, dtype=torch.int32),
                               instances=[lane])
        exact = C._leaves(carry["cache"])
        padded = C._leaves(tapi.take_state(tcfg, tcarry["cache"], lane, 0))
        for g, w in zip(padded, exact):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_decode_alive_freezes_dead_lanes():
    """B=2 slots per instance; the dead slots (0, 1) and (1, 0) keep every
    cache leaf bit for bit (both KV groups and the mamba state); the live
    ones change."""
    _, tcfg, _, tp = _both()
    rng = np.random.default_rng(9)
    cache = tapi.make_cache(tcfg, M, 2, CONTEXT, device="cpu")
    cache = C.tree_map(lambda t: torch.from_numpy(
        rng.standard_normal(tuple(t.shape)).astype(np.float32)), cache)
    before = C.tree_map(lambda t: t.clone(), cache)
    alive = torch.tensor([[True, False], [False, True]])
    tok = torch.from_numpy(rng.integers(1, 257, (M, 2, 1)).astype(np.int32))
    pos = torch.tensor([[130, 200], [170, 140]], dtype=torch.int32)
    tapi.decode_step_sample(tcfg, tp, cache, tok, pos, alive=alive)
    for slot, live in (((0, 1), False), ((1, 0), False), ((0, 0), True), ((1, 1), True)):
        now = C._leaves(tapi.take_state(tcfg, cache, *slot))
        was = C._leaves(tapi.take_state(tcfg, before, *slot))
        same = [torch.equal(a, b) for a, b in zip(now, was)]
        assert all(same) if not live else not any(same), (slot, same)


def test_take_put_state_moves_one_slot():
    _, tcfg, _, _ = _both()
    rng = np.random.default_rng(10)
    src = tapi.make_cache(tcfg, M, 2, CONTEXT, device="cpu")
    src = C.tree_map(lambda t: torch.from_numpy(
        rng.standard_normal(tuple(t.shape)).astype(np.float32)), src)
    grid = tapi.make_cache(tcfg, M, 3, CONTEXT + 32, device="cpu")
    one = tapi.take_state(tcfg, src, 1, 0)
    assert one["kv"][0].k.shape[1:3] == (1, 1)
    assert one["ssm"]["h"].data_ptr() == src["ssm"]["h"][:, 1, 0].data_ptr()
    tapi.put_state(tcfg, grid, one, 0, 2)
    for g, s_ in zip(C._leaves(tapi.take_state(tcfg, grid, 0, 2)), C._leaves(one)):
        n = min(g.shape[3], s_.shape[3]) if g.ndim == 6 else None
        if n is None:
            assert torch.equal(g, s_)
        else:                        # the global cache's context is prefix-clipped
            assert torch.equal(g[:, :, :, :n], s_[:, :, :, :n])
            assert g[:, :, :, n:].eq(0).all()
    for g in C._leaves(tapi.take_state(tcfg, grid, 1, 0)):
        assert g.eq(0).all()


@pytest.mark.parametrize("k", [1, 8])
def test_engine_streams_match_jax_engine(k):
    """Prompts from 1 to 60 tokens (over the meta prefix and across the
    SWA ring), chunk 16 under a per-step budget, mixed budgets so lanes
    die mid-block at K=8: greedy streams and device-call counts equal the
    JAX engine's."""
    from repro.serving import MultiModelServer as JServer
    from repro.serving import Request as JRequest
    from repro_torch.serving import MultiModelServer, Request

    jcfg, tcfg, jp, tp = _both()
    rng = np.random.default_rng(11)
    reqs = [(i % 2, rng.integers(1, 257, n).tolist(), 2 + i % 5)
            for i, n in enumerate((45, 1, 60, 7, 33, 20))]
    kw = dict(slots_per_instance=2, max_context=192, temperature=0.0, prefill_chunk=16,
              prefill_lanes=3, chunk_budget=3, decode_steps=k)

    def drain(srv, req_cls):
        for inst, prompt, n in reqs:
            srv.submit(req_cls(inst, list(prompt), n))
        out = {r.request_id: r.tokens for r in srv.run_until_drained()}
        return out, srv.steps, srv.prefill.device_calls

    want = drain(JServer(jcfg, jp, **kw), JRequest)
    got = drain(MultiModelServer(tcfg, tp, device="cpu", **kw), Request)
    assert len(want[0]) == len(reqs) and got == want


def test_engine_refuses_a_context_below_meta_plus_window():
    from repro_torch.serving import MultiModelServer

    _, tcfg, _, tp = _both()
    with pytest.raises(ValueError, match="meta\\+window"):
        MultiModelServer(tcfg, tp, slots_per_instance=1, max_context=159, device="cpu")


def test_prefill_chunk_clamped_to_swa_ring():
    """A chunk must map to distinct slots of the 32-slot SWA ring."""
    from repro_torch.serving.prefill import ChunkedPrefill

    _, tcfg, _, _ = _both()
    pre = ChunkedPrefill(tcfg, max_context=192, device="cpu", chunk=64, lanes=1)
    assert (pre.chunk, pre.prefix, pre.max_prompt_len()) == (32, R, 192 - R)
