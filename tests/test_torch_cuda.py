"""The Hopper kernels against their plain versions, on the card.

Marked ``cuda``: each test decides inside itself whether a card is
present and skips when it is not (so every worker collects the same
tests).  Run on a machine with an H100:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-4 (summation order only: the kernels split the
reduction over warps, cuBLAS tiles it), bf16 3e-2 relative to the
largest magnitude (one bf16 ulp is 2^-8 = 3.9e-3, and a changed order
can flip the rounding of an intermediate that later stages amplify).
"""
import math

import pytest
import torch

from repro_torch.kernels import chunk_prefill_attn as cpa
from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import decode_layer as dl
from repro_torch.kernels import fused_matmul as fm
from repro_torch.kernels import group_norm as gn
from repro_torch.kernels import mlstm_chunk as ml
from repro_torch.kernels import ops
from repro_torch.kernels import slstm_cell as sc

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp(min=1.0)).item()


def _tol(dt):
    return 1e-4 if dt == torch.float32 else 3e-2


def _layer(dev, dt, m, b, d, h, kvh, hd, ff, s, bias, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shp, sc=1.0: (torch.randn(shp, generator=g, device=dev) * sc)
    lp = {
        "attn_norm": 1 + 0.1 * r(m, d), "mlp_norm": 1 + 0.1 * r(m, d),
        "wq": r(m, d, h * hd, sc=d ** -0.5).to(dt), "wk": r(m, d, kvh * hd, sc=d ** -0.5).to(dt),
        "wv": r(m, d, kvh * hd, sc=d ** -0.5).to(dt), "wo": r(m, h * hd, d, sc=(h * hd) ** -0.5).to(dt),
        "w_gate": r(m, d, ff, sc=d ** -0.5).to(dt), "w_up": r(m, d, ff, sc=d ** -0.5).to(dt),
        "w_down": r(m, ff, d, sc=ff ** -0.5).to(dt),
    }
    if bias:
        lp.update(bq=r(m, h * hd, sc=0.1).to(dt), bk=r(m, kvh * hd, sc=0.1).to(dt),
                  bv=r(m, kvh * hd, sc=0.1).to(dt))
    x = r(m, b, d).to(dt)
    ck, cv = r(m, b, s, kvh, hd).to(dt), r(m, b, s, kvh, hd).to(dt)
    return lp, x, ck, cv


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,bias,window", [(4, 2, False, 0), (4, 4, True, 0),
                                               (4, 1, False, 12), (8, 2, True, 5)])
@pytest.mark.parametrize("s", [16, 300])
def test_decode_layer_kernel(dev, dt, h, kvh, bias, window, s):
    """A 300-slot ring is attended in several slot splits."""
    m, b, d, hd, ff = 2, 3, 64, 16, 96
    lp, x, ck, cv = _layer(dev, dt, m, b, d, h, kvh, hd, ff, s, bias)
    for base in (0, s - 2, s, 2 * s + 3):
        pos = (base + torch.arange(m * b, device=dev, dtype=torch.int32)).reshape(m, b)
        kw = dict(num_heads=h, head_dim=hd, rope_theta=10000.0, window=window)
        want = dl.decode_layer_plain(lp, x, ck.clone(), cv.clone(), pos, **kw)
        got = ops.decode_layer(lp, x, ck.clone(), cv.clone(), pos, **kw)
        torch.cuda.synchronize()
        for gt, wt, name in zip(got, want, ("x", "k", "v")):
            assert _err(gt, wt) <= _tol(dt), (name, base)


def test_decode_layer_kernel_alive(dev):
    lp, x, ck, cv = _layer(dev, torch.float32, 2, 2, 32, 4, 2, 16, 64, 8, False)
    pos = torch.tensor([[3, 9], [0, 20]], dtype=torch.int32, device=dev)
    alive = torch.tensor([[True, False], [False, True]], device=dev)
    k0 = ck.clone()
    _, k1, _ = ops.decode_layer(lp, x, ck, cv, pos, num_heads=4, head_dim=16,
                                rope_theta=10000.0, alive=alive)
    torch.cuda.synchronize()
    assert torch.equal(k1[0, 1], k0[0, 1]) and torch.equal(k1[1, 0], k0[1, 0])
    assert not torch.equal(k1[0, 0], k0[0, 0])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_logits_kernel_first_occurrence(dev, dt):
    m, b, d, v = 2, 3, 64, 257
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(m, b, d, generator=g, device=dev).to(dt)
    scale = 1 + 0.1 * torch.randn(m, d, generator=g, device=dev)
    head = torch.randn(m, d, v, generator=g, device=dev) * d ** -0.5
    n = x.float() / x.float().pow(2).mean(-1, keepdim=True).add(1e-5).sqrt()
    head[:, :, 7] = (n * scale[:, None]).sum(1) / b       # dominant column
    head[:, :, 100] = head[:, :, 7]
    head[:, :, 255] = head[:, :, 7]
    tok, val = ops.logits_argmax(x, scale, head)
    want_tok, want_val = dl.logits_argmax_plain(x, scale, head)
    torch.cuda.synchronize()
    assert (tok == 7).all() and torch.equal(tok, want_tok)
    assert _err(val, want_val) <= 1e-4


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_logits_kernel_odd_vocab_duplicated_max(dev, dt):
    """V = 32001 (hymba-1.5b): an odd row length takes the kernel's scalar
    loads; a duplicated winning column gives the first copy."""
    m, b, d, v = 2, 2, 64, 32001
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(m, b, d, generator=g, device=dev).to(dt)
    scale = 1 + 0.1 * torch.randn(m, d, generator=g, device=dev)
    head = torch.randn(m, d, v, generator=g, device=dev) * d ** -0.5
    n = x.float() / x.float().pow(2).mean(-1, keepdim=True).add(1e-5).sqrt()
    head[:, :, 31999] = (n * scale[:, None]).sum(1) / b
    head[:, :, 32000] = head[:, :, 31999]
    head[:, :, 20000] = head[:, :, 31999]
    tok, val = ops.logits_argmax(x, scale, head)
    want_tok, want_val = dl.logits_argmax_plain(x, scale, head)
    torch.cuda.synchronize()
    assert (tok == 20000).all() and torch.equal(tok, want_tok)
    assert _err(val, want_val) <= 1e-4


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,b,c,h,kvh,sc,hd,pin,win,sink", [
    (2, 1, 8, 4, 2, 16, 8, 0, 0, 0), (1, 2, 4, 4, 4, 24, 8, 0, 6, 0),
    (2, 1, 8, 8, 2, 20, 16, 4, 8, 4), (1, 1, 5, 3, 1, 13, 8, 0, 0, 0),
    (2, 2, 32, 8, 2, 200, 64, 0, 0, 0)])
def test_chunk_prefill_kernel(dev, dt, m, b, c, h, kvh, sc, hd, pin, win, sink):
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(m, b, c, h, hd, generator=g, device=dev).to(dt)
    k = torch.randn(m, b, sc + c, kvh, hd, generator=g, device=dev).to(dt)
    v = torch.randn(m, b, sc + c, kvh, hd, generator=g, device=dev).to(dt)
    off = torch.randint(max(pin, 1), sc + 5, (m, b), generator=g, device=dev,
                        dtype=torch.int32)
    kw = dict(s_cache=sc, pin=pin, window=win, sink=sink)
    want = cpa.chunk_prefill_attention_plain(q, k, v, off, **kw)
    got = ops.chunk_prefill_attention(q, k, v, off, **kw)
    torch.cuda.synchronize()
    assert _err(got, want) <= _tol(dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sc,win", [(160, 32), (1152, 1024), (192, 1 << 30)])
def test_chunk_prefill_kernel_hymba_geometry(dev, dt, sc, win):
    """Hymba's chunk attention: H=25 over KVH=5 (G=5), the SWA group with
    128 pinned meta slots, window and sink (pin=128, sink=128), and the
    global group with window=1<<30 (no overflow in q_pos - k_pos)."""
    g = torch.Generator(device=dev).manual_seed(6)
    m, b, c, h, kvh, hd = 2, 2, 32, 25, 5, 64
    pin = 128 if win < sc else 0
    q = torch.randn(m, b, c, h, hd, generator=g, device=dev).to(dt)
    k = torch.randn(m, b, sc + c, kvh, hd, generator=g, device=dev).to(dt)
    v = torch.randn(m, b, sc + c, kvh, hd, generator=g, device=dev).to(dt)
    off = torch.tensor([[0, 100], [150, 3 * sc + 17]], dtype=torch.int32, device=dev)
    kw = dict(s_cache=sc, pin=pin, window=win, sink=128)
    want = cpa.chunk_prefill_attention_plain(q, k, v, off, **kw)
    got = ops.chunk_prefill_attention(q, k, v, off, **kw)
    torch.cuda.synchronize()
    assert _err(got, want) <= _tol(dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,hd,s", [(4, 4, 64, 300), (25, 5, 64, 1536), (16, 1, 128, 200),
                                        (10, 2, 8, 129)])
def test_decode_attention_kernel(dev, dt, h, kvh, hd, s):
    """G in {1, 5, 16, 5}; kv_len 1, S, one past a split boundary, a
    non-multiple of the 128-slot split and of the 64-slot tile."""
    g = torch.Generator(device=dev).manual_seed(7)
    m, b = 2, 3
    q = torch.randn(m, b, h, hd, generator=g, device=dev).to(dt)
    k = torch.randn(m, b, s, kvh, hd, generator=g, device=dev).to(dt)
    v = torch.randn(m, b, s, kvh, hd, generator=g, device=dev).to(dt)
    kv_len = torch.tensor([[1, s, min(129, s)], [s - 1, 77, min(200, s)]], dtype=torch.int32,
                          device=dev)
    ops.reset_launches()
    got = ops.decode_attention(q, k, v, kv_len)
    want = da.decode_attention_plain(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert ops.launches()["decode_attention"] == 1
    assert got.dtype == dt and _err(got, want) <= _tol(dt)
    # slots past kv_len are never read: poisoning them changes nothing
    k2, v2 = k.clone(), v.clone()
    mask = torch.arange(s, device=dev)[None, None] >= kv_len[..., None]
    k2[mask], v2[mask] = float("nan"), float("nan")
    assert torch.equal(ops.decode_attention(q, k2, v2, kv_len), got)


def _cell(dev, dt, rdt, m, b, s, h, hd, seed=3):
    """Gate pre-activations with neutral (junk) steps on some lanes and a
    non-zero carried state."""
    g = torch.Generator(device=dev).manual_seed(seed)
    d = h * hd
    pre = torch.randn(m, b, s, 4, d, generator=g, device=dev)
    neutral = torch.tensor([0.0, -1e30, 1e30, 0.0], device=dev)[:, None]
    pre[0, -1, s // 2:] = neutral
    pre[-1, 0, :] = neutral
    r = (torch.randn(m, 4, h, hd, hd, generator=g, device=dev) * hd ** -0.5).to(rdt)
    state = (torch.randn(m, b, d, generator=g, device=dev),
             torch.rand(m, b, d, generator=g, device=dev) + 0.5,
             (0.5 * torch.randn(m, b, d, generator=g, device=dev)).to(dt),
             torch.randn(m, b, d, generator=g, device=dev))
    return pre.to(dt), r, state


@pytest.mark.parametrize("dt,rdt", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("m,b,s,h,hd", [(2, 1, 1, 2, 32), (2, 3, 9, 2, 64),
                                        (1, 6, 5, 1, 96), (2, 4, 32, 4, 128)])
def test_slstm_cell_kernel(dev, dt, rdt, m, b, s, h, hd):
    """hs and the carried (c, n, h, m); B = 6 spans two lane tiles; a
    lane that is junk throughout keeps c, n and m bit for bit."""
    pre, r, state = _cell(dev, dt, rdt, m, b, s, h, hd)
    want_st = tuple(t.clone() for t in state)
    want_hs, _ = sc.slstm_cell_plain(pre, r, want_st, num_heads=h)
    got_st = tuple(t.clone() for t in state)
    got_hs, _ = ops.slstm_cell(pre, r, got_st, num_heads=h)
    torch.cuda.synchronize()
    assert _err(got_hs, want_hs) <= _tol(dt)
    for gt, wt, name in zip(got_st, want_st, "cnhm"):
        assert _err(gt, wt) <= _tol(dt), name
    for i in (0, 1, 3):
        assert torch.equal(got_st[i][-1, 0], state[i][-1, 0])


def test_slstm_cell_kernel_alive(dev):
    pre, r, state = _cell(dev, torch.float32, torch.float32, 2, 2, 1, 2, 32)
    alive = torch.tensor([[True, False], [False, True]], device=dev)
    st = tuple(t.clone() for t in state)
    ops.slstm_cell(pre, r, st, num_heads=2, alive=alive)
    want = tuple(t.clone() for t in state)
    sc.slstm_cell_plain(pre, r, want, num_heads=2, alive=alive)
    torch.cuda.synchronize()
    for i in range(4):
        assert torch.equal(st[i][0, 1], state[i][0, 1])
        assert torch.equal(st[i][1, 0], state[i][1, 0])
        assert _err(st[i], want[i]) <= 1e-4


def test_cuda_tensors_count_launches(dev):
    ops.reset_launches()
    q = torch.randn(1, 1, 4, 4, 8, device=dev)
    kv = torch.randn(1, 1, 20, 2, 8, device=dev)
    ops.chunk_prefill_attention(q, kv, kv, torch.tensor([[3]], device=dev), s_cache=16)
    assert ops.launches()["chunk_prefill_attention"] == 1
    assert math.isfinite(float(ops.logits_sample(
        torch.randn(1, 2, 8, device=dev), torch.ones(1, 8, device=dev),
        torch.randn(1, 8, 16, device=dev)).sum()))
    assert ops.launches()["logits_sample"] == 1
    state = tuple(torch.zeros(1, 1, 32, device=dev) for _ in range(4))
    ops.slstm_cell(torch.randn(1, 1, 2, 4, 32, device=dev),
                   torch.randn(1, 4, 1, 32, 32, device=dev), state, num_heads=1)
    assert ops.launches()["slstm_cell"] == 1
    ops.decode_attention(torch.randn(1, 1, 4, 8, device=dev), kv[:, :, :16], kv[:, :, :16],
                         torch.tensor([[3]], dtype=torch.int32, device=dev))
    assert ops.launches()["decode_attention"] == 1
    ops.fused_matmul(torch.randn(2, 3, 16, device=dev), torch.randn(2, 16, 8, device=dev))
    assert ops.launches()["fused_matmul"] == 1
    ops.group_rms_norm(torch.randn(2, 3, 16, device=dev), torch.ones(2, 16, device=dev))
    assert ops.launches()["group_rms_norm"] == 1
    q = torch.randn(1, 1, 1, 8, 64, device=dev)
    ops.mlstm_chunkwise(q, q, q, torch.zeros(1, 1, 1, 8, device=dev),
                        torch.zeros(1, 1, 1, 8, device=dev), chunk=4)
    assert ops.launches()["mlstm_chunkwise"] == 1


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,t,d,f,bias", [(4, 4, 2048, 5632, False), (3, 128, 768, 3072, True),
                                          (2, 77, 64, 200, True), (1, 1, 8, 8, False),
                                          (5, 130, 96, 72, False)])
def test_fused_matmul_kernel(dev, dt, m, t, d, f, bias):
    """The skinny serving shape, the BERT shape (cut to 3 instances), odd T
    and F not a multiple of the 64-wide tile."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(m, t, d, generator=g, device=dev).to(dt)
    w = (torch.randn(m, d, f, generator=g, device=dev) * d ** -0.5).to(dt)
    b = torch.randn(m, f, generator=g, device=dev) if bias else None
    got = fm.fused_matmul_cuda(x, w, b)
    want = fm.fused_matmul_plain(x, w, b)
    torch.cuda.synchronize()
    assert got.dtype == dt and _err(got, want) <= _tol(dt)


@pytest.mark.parametrize("dt,sdt", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("m,t,d", [(32, 128, 768), (4, 128, 2048), (3, 5, 8), (2, 9, 8192)])
def test_group_rms_norm_kernel(dev, dt, sdt, m, t, d):
    g = torch.Generator(device=dev).manual_seed(1)
    x = (3 * torch.randn(m, t, d, generator=g, device=dev)).to(dt)
    scale = (1 + 0.1 * torch.randn(m, d, generator=g, device=dev)).to(sdt)
    got = gn.group_rms_norm_cuda(x, scale)
    want = gn.group_rms_norm_plain(x, scale)
    torch.cuda.synchronize()
    assert got.dtype == dt and _err(got, want) <= _tol(dt)


def _mlstm_inputs(dev, dt, m, b, h, s, hd, seed=2, ends=None):
    """q, k, v and gates with the serving scales (k / sqrt(hd) is applied
    inside); lanes listed in ``ends`` take gate-neutral steps from there on
    (input -1e30, forget 0) with junk q, k, v."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(m, b, h, s, hd, generator=g, device=dev).to(dt) for _ in range(3))
    lf = torch.nn.functional.logsigmoid(2 + torch.randn(m, b, h, s, generator=g, device=dev))
    li = torch.randn(m, b, h, s, generator=g, device=dev)
    for (mi, bi, hi), e in (ends or {}).items():
        li[mi, bi, hi, e:] = -1e30
        lf[mi, bi, hi, e:] = 0.0
    return q, k, v, lf, li


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,b,h,s,hd,chunk", [(2, 1, 2, 32, 1024, 32), (1, 2, 3, 256, 128, 64),
                                              (1, 1, 1, 24, 64, 16), (2, 2, 2, 40, 64, 8)])
def test_mlstm_chunkwise_kernel(dev, dt, m, b, h, s, hd, chunk):
    """h and the final C, n, m against the plain version: xlstm-1.3b's
    hd=1024 in one chunk, hd=128 over four chunks of 64, a chunk of 16
    clamped to 12 on S=24 (not a multiple of the kernels' 16-row thread
    grid), five chunks of 8."""
    q, k, v, lf, li = _mlstm_inputs(dev, dt, m, b, h, s, hd)
    gh, gst = ml.mlstm_chunkwise_cuda(q, k, v, lf, li, chunk=chunk)
    wh, wst = ml.mlstm_chunkwise_plain(q, k, v, lf, li, chunk=chunk)
    torch.cuda.synchronize()
    assert gh.dtype == dt
    assert _err(gh, wh) <= _tol(dt)
    for a, w in zip(gst, wst):
        assert _err(a, w) <= _tol(dt)


def test_mlstm_chunkwise_kernel_padded_steps_exact(dev):
    """Gate-neutral padded steps add exactly nothing: other junk in their
    q, k, v leaves h at the valid steps and the final state bit for bit."""
    ends = {(0, 0, 0): 100, (0, 0, 1): 1, (0, 1, 0): 64, (0, 1, 1): 255}
    q, k, v, lf, li = _mlstm_inputs(torch.device("cuda"), torch.bfloat16, 1, 2, 2, 256, 128,
                                    ends=ends)
    h1, st1 = ml.mlstm_chunkwise_cuda(q, k, v, lf, li, chunk=64)
    wh, wst = ml.mlstm_chunkwise_plain(q, k, v, lf, li, chunk=64)
    for (mi, bi, hi), e in ends.items():
        for t in (q, k, v):
            t[mi, bi, hi, e:] = 7 * torch.randn_like(t[mi, bi, hi, e:])
    h2, st2 = ml.mlstm_chunkwise_cuda(q, k, v, lf, li, chunk=64)
    torch.cuda.synchronize()
    for (mi, bi, hi), e in ends.items():
        assert torch.equal(h1[mi, bi, hi, :e], h2[mi, bi, hi, :e])
    for a, b_ in zip(st1, st2):
        assert torch.equal(a, b_)
    assert _err(h1, wh) <= 3e-2 and all(_err(a, w) <= 3e-2 for a, w in zip(st1, wst))
