"""The port's plain kernel versions against ``repro.kernels.ref`` (f32).

Inputs are made from a seed with numpy and handed to both packages.
Tolerance: 2e-5 absolute and relative.  Both sides compute in f32 with
the same rounding points; what is left is summation order (XLA's vs
torch's matmul and softmax reductions), a few ulps over these widths.
Greedy tokens are compared exactly, ties included.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro_torch.kernels import chunk_prefill_attn as cpa
from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import decode_layer as dl
from repro_torch.kernels import fused_matmul as fm
from repro_torch.kernels import group_norm as gn
from repro_torch.kernels import mlstm_chunk as ml
from repro_torch.kernels import ops

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _layer_inputs(seed, m, b, d, h, kvh, hd, ff, s, bias=False):
    rng = np.random.default_rng(seed)
    r = lambda *shp: (rng.standard_normal(shp) * 0.1).astype(np.float32)
    lp = {
        "attn_norm": 1.0 + r(m, d),
        "wq": r(m, d, h * hd), "wk": r(m, d, kvh * hd), "wv": r(m, d, kvh * hd),
        "wo": r(m, h * hd, d), "mlp_norm": 1.0 + r(m, d),
        "w_gate": r(m, d, ff), "w_up": r(m, d, ff), "w_down": r(m, ff, d),
    }
    if bias:
        lp.update(bq=r(m, h * hd), bk=r(m, kvh * hd), bv=r(m, kvh * hd))
    x = r(m, b, d)
    ck, cv = r(m, b, s, kvh, hd), r(m, b, s, kvh, hd)
    pos = rng.integers(0, 2 * s, (m, b)).astype(np.int32)
    return lp, x, ck, cv, pos


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_layer(lp, x, ck, cv, pos, **kw):
    want = ref.decode_layer({k: jnp.asarray(v) for k, v in lp.items()},
                            jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                            jnp.asarray(pos), **kw)
    tlp = {k: _t(v) for k, v in lp.items()}
    got = ops.decode_layer(tlp, _t(x), _t(ck), _t(cv), _t(pos), **kw)
    for g, w, name in zip(got, want, ("x", "k_cache", "v_cache")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("h,kvh", [(4, 2), (4, 4), (4, 1), (8, 2)])
def test_decode_layer_plain_matches_ref(h, kvh):
    """GQA, MHA and MQA."""
    _assert_layer(*_layer_inputs(0, 2, 3, 48, h, kvh, 32, 96, 16),
                  num_heads=h, head_dim=32, rope_theta=10000.0)


@pytest.mark.parametrize("theta", [0.0, 10000.0])
def test_decode_layer_plain_qkv_bias(theta):
    """qwen-style biased QKV, with and without RoPE."""
    _assert_layer(*_layer_inputs(1, 2, 2, 32, 4, 4, 16, 64, 8, bias=True),
                  num_heads=4, head_dim=16, rope_theta=theta)


@pytest.mark.parametrize("base", [0, 14, 16, 35])
def test_decode_layer_plain_ring_wrap_window(base):
    """Positions straddling the ring wrap (bases 0, S-2, S, 2S+3) with a
    sliding window shorter than the ring."""
    s = 16
    lp, x, ck, cv, _ = _layer_inputs(2, 1, 4, 32, 4, 2, 16, 64, s)
    pos = (base + np.arange(4, dtype=np.int32))[None]
    _assert_layer(lp, x, ck, cv, pos, num_heads=4, head_dim=16,
                  rope_theta=10000.0, window=12)


def test_decode_layer_plain_alive_freezes_ring():
    """A lane with alive=False keeps its ring; live lanes append."""
    lp, x, ck, cv, pos = _layer_inputs(3, 2, 2, 32, 4, 2, 16, 64, 8)
    tlp = {k: _t(v) for k, v in lp.items()}
    alive = torch.tensor([[True, False], [False, True]])
    k0, v0 = _t(ck).clone(), _t(cv).clone()
    _, k1, v1 = ops.decode_layer(tlp, _t(x), _t(ck), _t(cv), _t(pos), num_heads=4,
                                 head_dim=16, rope_theta=10000.0, alive=alive)
    for mi, bi in ((0, 1), (1, 0)):
        assert torch.equal(k1[mi, bi], k0[mi, bi]) and torch.equal(v1[mi, bi], v0[mi, bi])
    for mi, bi in ((0, 0), (1, 1)):
        assert not torch.equal(k1[mi, bi], k0[mi, bi])


def test_logits_plain_matches_ref_with_ties():
    """First-occurrence ties forced by duplicated head columns, V prime."""
    rng = np.random.default_rng(3)
    m, b, d, v = 2, 3, 32, 257
    x = rng.standard_normal((m, b, d)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal((m, d))).astype(np.float32)
    head = rng.standard_normal((m, d, v)).astype(np.float32)
    # make column 7 the winner everywhere, then duplicate it later
    head[:, :, 7] = 3.0 * np.sign(x.sum(axis=1))
    head[:, :, 100] = head[:, :, 7]
    head[:, :, 255] = head[:, :, 7]
    want = np.asarray(ref.logits_sample(jnp.asarray(x), jnp.asarray(scale),
                                        jnp.asarray(head)))
    tok, val = dl.logits_argmax_plain(_t(x), _t(scale), _t(head))
    np.testing.assert_array_equal(tok.numpy(), want)
    assert tok.dtype == torch.int32 and (tok.numpy() == 7).all()
    assert torch.equal(ops.logits_sample(_t(x), _t(scale), _t(head)), tok)
    n = x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-5) * scale[:, None]
    np.testing.assert_allclose(val.numpy(), np.einsum("mbd,md->mb", n, head[:, :, 7]),
                               rtol=1e-4, atol=1e-4)


# (m, b, c, h, kvh, s_cache, hd, pin, window, sink) — the reference sweep
CHUNK_ATTN_CASES = [
    (2, 1, 8, 4, 2, 16, 8, 0, 0, 0),      # GQA, full cache, mid-prompt
    (1, 2, 4, 4, 4, 24, 8, 0, 6, 0),      # MHA, sliding window, ring wrap
    (2, 1, 8, 8, 2, 20, 16, 4, 8, 4),     # pinned prefix + sink
    (1, 1, 5, 3, 1, 13, 8, 0, 0, 0),      # MQA, ragged everything
]


@pytest.mark.parametrize("m,b,c,h,kvh,sc,hd,pin,win,sink", CHUNK_ATTN_CASES)
def test_chunk_prefill_plain_matches_ref(m, b, c, h, kvh, sc, hd, pin, win, sink):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((m, b, c, h, hd)).astype(np.float32)
    k = rng.standard_normal((m, b, sc + c, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((m, b, sc + c, kvh, hd)).astype(np.float32)
    offset = rng.integers(max(pin, 1), sc + 5, (m, b)).astype(np.int32)
    want = ref.chunk_prefill_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(offset), s_cache=sc, pin=pin,
                                       window=win, sink=sink)
    got = ops.chunk_prefill_attention(_t(q), _t(k), _t(v), _t(offset), s_cache=sc,
                                      pin=pin, window=win, sink=sink)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_tensors_route_to_plain_without_launches():
    """CPU tensors take the plain versions; no kernel launch is counted."""
    ops.reset_launches()
    lp, x, ck, cv, pos = _layer_inputs(4, 1, 2, 32, 4, 2, 16, 64, 8)
    tlp = {k: _t(v) for k, v in lp.items()}
    got = ops.decode_layer(tlp, _t(x), _t(ck).clone(), _t(cv).clone(), _t(pos),
                           num_heads=4, head_dim=16, rope_theta=10000.0)
    want = dl.decode_layer_plain(tlp, _t(x), _t(ck).clone(), _t(cv).clone(), _t(pos),
                                 num_heads=4, head_dim=16, rope_theta=10000.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    q = torch.randn(1, 1, 4, 4, 8)
    kv = torch.randn(1, 1, 20, 2, 8)
    off = torch.tensor([[3]], dtype=torch.int32)
    assert torch.equal(
        ops.chunk_prefill_attention(q, kv, kv, off, s_cache=16),
        cpa.chunk_prefill_attention_plain(q, kv, kv, off, s_cache=16))
    ops.logits_sample(torch.randn(1, 2, 8), torch.ones(1, 8), torch.randn(1, 8, 16))
    state = tuple(torch.zeros(1, 2, 8) for _ in range(4))
    ops.slstm_cell(torch.randn(1, 2, 3, 4, 8), torch.randn(1, 4, 2, 4, 4), state,
                   num_heads=2)
    assert torch.equal(
        ops.decode_attention(q[:, :, 0], kv, kv, torch.tensor([[5]], dtype=torch.int32)),
        da.decode_attention_plain(q[:, :, 0], kv, kv, torch.tensor([[5]], dtype=torch.int32)))
    x, w = torch.randn(2, 3, 8), torch.randn(2, 8, 4)
    assert torch.equal(ops.fused_matmul(x, w), fm.fused_matmul_plain(x, w))
    assert torch.equal(ops.group_rms_norm(x, torch.ones(2, 8)),
                       gn.group_rms_norm_plain(x, torch.ones(2, 8)))
    qm = torch.randn(1, 1, 1, 4, 8)
    gates = torch.zeros(1, 1, 1, 4)
    assert torch.equal(ops.mlstm_chunkwise(qm, qm, qm, gates, gates, chunk=2)[0],
                       ml.mlstm_chunkwise_plain(qm, qm, qm, gates, gates, chunk=2)[0])
    assert ops.launches() == {"decode_layer": 0, "logits_sample": 0,
                              "chunk_prefill_attention": 0, "slstm_cell": 0,
                              "decode_attention": 0, "fused_matmul": 0,
                              "group_rms_norm": 0, "mlstm_chunkwise": 0}


@pytest.mark.parametrize("m,t,d,f,bias", [(2, 5, 16, 24, False), (3, 1, 32, 8, True),
                                          (1, 7, 8, 40, True)])
def test_fused_matmul_plain_matches_ref(m, t, d, f, bias):
    rng = np.random.default_rng(21)
    x = rng.standard_normal((m, t, d)).astype(np.float32)
    w = rng.standard_normal((m, d, f)).astype(np.float32)
    b = rng.standard_normal((m, f)).astype(np.float32) if bias else None
    want = ref.fused_matmul(jnp.asarray(x), jnp.asarray(w),
                            None if b is None else jnp.asarray(b))
    got = ops.fused_matmul(_t(x), _t(w), None if b is None else _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_matmul_plain_casts_weights_to_x_dtype():
    """w in x's dtype, the sum in f32, the bias in f32, one cast at the
    end (``ref.fused_matmul``): bf16 x with f32 weights rounds the weights."""
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    w = rng.standard_normal((2, 16, 8)).astype(np.float32)
    b = rng.standard_normal((2, 8)).astype(np.float32)
    want = ref.fused_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b))
    got = fm.fused_matmul_plain(_t(x).bfloat16(), _t(w), _t(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("m,t,d", [(2, 5, 16), (3, 1, 64), (1, 9, 8)])
def test_group_rms_norm_plain_matches_ref(m, t, d):
    rng = np.random.default_rng(23)
    x = (3 * rng.standard_normal((m, t, d))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal((m, d))).astype(np.float32)
    want = ref.group_rms_norm(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_allclose(ops.group_rms_norm(_t(x), _t(scale)).numpy(), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("s,chunk,padded", [(16, 16, False), (24, 8, True), (20, 8, False)])
def test_mlstm_chunkwise_plain_matches_ref(s, chunk, padded):
    """h and the final (C, n, m) against ``ref.mlstm_chunkwise`` from zero
    state, one or several chunks (chunk 8 on S=20 clamps to 5), with
    gate-neutral padded steps (input -1e30, forget 0) in one lane."""
    rng = np.random.default_rng(24)
    m, b, h, hd = 2, 2, 2, 8
    q, k, v = (rng.standard_normal((m, b, h, s, hd)).astype(np.float32) for _ in range(3))
    lf = np.log(1 / (1 + np.exp(-(2 + rng.standard_normal((m, b, h, s)))))).astype(np.float32)
    li = rng.standard_normal((m, b, h, s)).astype(np.float32)
    if padded:
        li[0, 1, 1, 13:] = -1e30
        lf[0, 1, 1, 13:] = 0.0
    wh, (wc, wn, wm) = ref.mlstm_chunkwise(*(jnp.asarray(a) for a in (q, k, v, lf, li)),
                                           chunk=chunk)
    gh, (gc, gn_, gm) = ops.mlstm_chunkwise(*(_t(a) for a in (q, k, v, lf, li)), chunk=chunk)
    for got, want in ((gh, wh), (gc, wc), (gn_, wn), (gm, wm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
