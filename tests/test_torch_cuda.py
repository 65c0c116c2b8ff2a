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
import dataclasses
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


def _part_err(got, want):
    """Relative to the largest magnitude of ``want`` with no floor: for a
    partial with no residual, whose values lie far below 1."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


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


# per-rank widths under tensor parallelism: (d, h, kvh, hd, ff, bias)
PHASE_WIDTHS = {
    "tinyllama-T2": (2048, 16, 2, 64, 2816, False),
    "tinyllama-T4": (2048, 8, 1, 64, 1408, False),
    "qwen1.5-T2": (1024, 8, 8, 64, 1408, True),
}


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", sorted(PHASE_WIDTHS))
def test_decode_layer_phase_kernels(dev, dt, width):
    """The attention phase (wrapped ring, lanes frozen by ``alive``) and
    the FFN phase at a rank's widths, against their plain versions.  The
    partials are held relative to their own largest magnitude."""
    d, h, kvh, hd, ff, bias = PHASE_WIDTHS[width]
    m, b, s = 2, 3, 300
    lp, x, ck, cv = _layer(dev, dt, m, b, d, h, kvh, hd, ff, s, bias)
    pos = (2 * s - 4 + torch.arange(m * b, device=dev, dtype=torch.int32)).reshape(m, b)
    alive = torch.tensor([[True, False, True], [False, True, True]], device=dev)
    kw = dict(num_heads=h, head_dim=hd, rope_theta=10000.0, alive=alive)
    want = dl.decode_layer_attn_plain(lp, x, ck.clone(), cv.clone(), pos, **kw)
    ops.reset_launches()
    got = ops.decode_layer_attn(lp, x, ck.clone(), cv.clone(), pos, **kw)
    torch.cuda.synchronize()
    for gt, wt, name, err in zip(got, want, ("partial", "k", "v"), (_part_err, _err, _err)):
        assert gt.dtype == dt and err(gt, wt) <= _tol(dt), name
    assert torch.equal(got[1][0, 1], ck[0, 1]) and torch.equal(got[2][1, 0], cv[1, 0])
    assert not torch.equal(got[1][0, 0], ck[0, 0])
    ffn = [lp[k] for k in ("mlp_norm", "w_gate", "w_up", "w_down")]
    got = ops.decode_layer_ffn(x, *ffn)
    want = dl.ffn_plain(x, *ffn)
    torch.cuda.synchronize()
    assert got.dtype == dt and _part_err(got, want) <= _tol(dt)
    assert ops.launches()["decode_layer_attn"] == ops.launches()["decode_layer_ffn"] == 1


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


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,hd,s", [(25, 5, 64, 1536), (5, 5, 64, 700), (16, 1, 32, 1000),
                                        (3, 1, 128, 129)])
def test_decode_attention_kernel_split_edges(dev, dt, h, kvh, hd, s):
    """kv_len at 1, S and on both sides of every split boundary of the
    launch plan (a split ending at kv_len, one starting at kv_len and
    loading nothing): one launch, within tolerance, bit for bit twice and
    with NaN in every slot past kv_len."""
    plan = da.launch_plan(1, s, h, kvh, hd, str(dt).removeprefix("torch."))
    lens = sorted({1, s} | {x for a, _ in plan.ranges[1:] for x in (a - 1, a, a + 1)})
    g = torch.Generator(device=dev).manual_seed(17)
    n = len(lens)
    q = torch.randn(n, 1, h, hd, generator=g, device=dev).to(dt)
    k = torch.randn(n, 1, s, kvh, hd, generator=g, device=dev).to(dt)
    v = torch.randn(n, 1, s, kvh, hd, generator=g, device=dev).to(dt)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)[:, None]
    ops.reset_launches()
    got = ops.decode_attention(q, k, v, kv_len)
    again = ops.decode_attention(q, k, v, kv_len)
    want = da.decode_attention_plain(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert ops.launches()["decode_attention"] == 2
    assert got.dtype == dt and _err(got, want) <= _tol(dt) and torch.equal(got, again)
    mask = torch.arange(s, device=dev)[None, None] >= kv_len[..., None]
    k2, v2 = k.clone(), v.clone()
    k2[mask], v2[mask] = float("nan"), float("nan")
    assert torch.equal(ops.decode_attention(q, k2, v2, kv_len), got)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,n", [(25, 5, 2), (25, 5, 5), (25, 5, 25), (4, 2, 4),
                                     (12, 3, 2)])
def test_decode_attention_sharded_kernel(dev, dt, h, kvh, n):
    """Each rank's block through the sharded wrapper (plans None, "kv",
    "expand" and an uneven straddle), concatenated over the heads,
    against the plain version on the whole heads; one launch per rank."""
    from types import SimpleNamespace

    from repro_torch.kernels.decode_layer import tp_head_plan

    g = torch.Generator(device=dev).manual_seed(9)
    m, b, hd, s = 2, 3, 64, 300
    q = torch.randn(m, b, h, hd, generator=g, device=dev).to(dt)
    k = torch.randn(m, b, s, kvh, hd, generator=g, device=dev).to(dt)
    v = torch.randn(m, b, s, kvh, hd, generator=g, device=dev).to(dt)
    kv_len = torch.tensor([[1, s, 129], [s - 1, 77, 200]], dtype=torch.int32, device=dev)
    plan = tp_head_plan(h, kvh, n)
    ops.reset_launches()
    outs = []
    for r in range(n):
        lo, hi, _ = da.rank_kv_heads(h, kvh, n, r) if plan else (0, kvh, None)
        outs.append(ops.decode_attention_sharded(
            q.chunk(n, 2)[r].contiguous() if plan else q, k[:, :, :, lo:hi].contiguous(),
            v[:, :, :, lo:hi].contiguous(), kv_len, plan=plan,
            tp=SimpleNamespace(rank=r, size=n), num_kv_heads=kvh))
    got = torch.cat(outs, 2) if plan else outs[0]
    want = da.decode_attention_plain(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert ops.launches()["decode_attention_sharded"] == n
    assert ops.launches()["decode_attention"] == 0
    assert got.dtype == dt and _err(got, want) <= _tol(dt)


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
                                          (5, 130, 96, 72, False), (2, 5, 20, 77, True)])
def test_fused_matmul_kernel(dev, dt, m, t, d, f, bias):
    """The skinny serving shape, the BERT shape (cut to 3 instances), odd T
    and F not a multiple of the 64-wide tile; D and F that leave the rows
    unaligned to 16 bytes (the element-wise loads)."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(m, t, d, generator=g, device=dev).to(dt)
    w = (torch.randn(m, d, f, generator=g, device=dev) * d ** -0.5).to(dt)
    b = torch.randn(m, f, generator=g, device=dev) if bias else None
    got = fm.fused_matmul_cuda(x, w, b)
    want = fm.fused_matmul_plain(x, w, b)
    torch.cuda.synchronize()
    assert got.dtype == dt and _err(got, want) <= _tol(dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_,t_", [(1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("m,t,d,f", [(4, 4, 2048, 5632), (32, 128, 768, 3072), (3, 4, 64, 77)])
def test_fused_matmul_sharded_rank_blocks(dev, dt, d_, t_, m, t, d, f):
    """Every rank's block of a (data=d_, model=t_) mesh through
    ``ops.fused_matmul_sharded`` (one launch each) against the plain
    version on the block, and the reassembled blocks against the plain
    version on the whole problem; M=3, F=77 divide neither 2-way axis."""
    from types import SimpleNamespace

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(m, t, d, generator=g, device=dev).to(dt)
    w = (torch.randn(m, d, f, generator=g, device=dev) * d ** -0.5).to(dt)
    b = torch.randn(m, f, generator=g, device=dev)
    ops.reset_launches()
    outs = []
    for r in range(d_ * t_):
        data, tp = SimpleNamespace(rank=r // t_, size=d_), SimpleNamespace(rank=r % t_, size=t_)
        xl, wl, bl = fm.rank_block(x, w, b, data.rank, d_, tp.rank, t_)
        outs.append(ops.fused_matmul_sharded(xl, wl, bl, data=data, tp=tp))
        torch.cuda.synchronize()
        assert _err(outs[-1], fm.fused_matmul_plain(xl, wl, bl)) <= _tol(dt)
    assert ops.launches()["fused_matmul_sharded"] == d_ * t_
    got = fm.assemble(outs, m, f, d_, t_)
    assert got.dtype == dt and _err(got, fm.fused_matmul_plain(x, w, b)) <= _tol(dt)


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
                                              (1, 1, 1, 24, 64, 16), (2, 2, 2, 40, 64, 8),
                                              (1, 1, 2, 256, 1024, 64), (1, 1, 2, 256, 1024, 128),
                                              (2, 1, 2, 128, 512, 128), (1, 1, 1, 300, 128, 100)])
def test_mlstm_chunkwise_kernel(dev, dt, m, b, h, s, hd, chunk):
    """h and the final C, n, m against the plain version: xlstm-1.3b's
    hd=1024 in one chunk, hd=128 over four chunks of 64, a chunk of 16
    clamped to 12 on S=24 (not a multiple of the tensor cores' 16 rows),
    five chunks of 8; hd=1024 over four chunks of 64 and two of 128 (C
    kept in registers over the chunks, clusters of 8 blocks), xlstm-1.3b's
    reference chunk of 128 in one chunk, three chunks of 100."""
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


# ---------------------------------------------------------------------------
# the Hopper designs' edges: the merged matmul's wide / skinny / split-D
# variants and the chunk attention's key split
# ---------------------------------------------------------------------------


def _matmul_inputs(dev, dt, m, t, d, f, bias, seed=4):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, t, d, generator=g, device=dev).to(dt)
    w = (torch.randn(m, d, f, generator=g, device=dev) * d ** -0.5).to(dt)
    b = torch.randn(m, f, generator=g, device=dev) if bias else None
    return x, w, b


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("t", [1, 8, 16, 17, 64, 127, 128, 129, 257])
def test_fused_matmul_kernel_rows(dev, t, bias):
    """Every row count the bf16 variants meet: skinny N = 8 (t <= 8) and 16
    (t <= 16), wide with one block row (t <= 128, w read once) and two or
    three; D = 200 not a multiple of the 64-deep k-step, F = 200 not a
    multiple of the 128-wide tile."""
    m, d, f = 3, 200, 200
    plan = fm.launch_plan(m, t, d, f)
    assert (plan.variant, plan.rows) == (("skinny", 8) if t <= 8 else ("skinny", 16) if t <= 16
                                         else ("wide", 128))
    x, w, b = _matmul_inputs(dev, torch.bfloat16, m, t, d, f, bias)
    got = fm.fused_matmul_cuda(x, w, b)
    want = fm.fused_matmul_plain(x, w, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and _err(got, want) <= 3e-2


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,t,d,f", [(89, 128, 128, 384), (397, 4, 64, 128),
                                     (10, 128, 256, 2504)])
def test_fused_matmul_kernel_partial_wave(dev, dt, m, t, d, f):
    """Instance counts whose tiles leave the last wave of the card part
    full: 267 wide tiles on 132 blocks, 397 skinny blocks; 100 wide tiles
    of 256 columns, the last of each instance part past F."""
    x, w, b = _matmul_inputs(dev, dt, m, t, d, f, True)
    got = fm.fused_matmul_cuda(x, w, b)
    want = fm.fused_matmul_plain(x, w, b)
    torch.cuda.synchronize()
    assert _err(got, want) <= _tol(dt)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("m,t,d,f,split", [(2, 4, 2048, 2816, 2), (2, 4, 2048, 2816, 8),
                                           (1, 16, 2048, 5632, 3), (1, 13, 520, 136, 0)])
def test_fused_matmul_kernel_split_d(dev, m, t, d, f, split, bias):
    """D split over a cluster of blocks: a 2x2 rank's block of the serving
    shape 2 and 8 ways, 3 ways (ragged: 32 k-steps) at T = 16, and the
    plan's own split of a two-tile shape (9 k-steps: 4 and 5): the
    partials summed in split order, the bias added once, and two calls
    bit-identical."""
    plan = fm.launch_plan(m, t, d, f)
    if split:
        plan = dataclasses.replace(plan, split=split, grid=(plan.grid[0], split, m))
    assert plan.split > 1 and plan.variant == "skinny"
    x, w, b = _matmul_inputs(dev, torch.bfloat16, m, t, d, f, bias)
    got = fm.launch(x, w, b, plan)
    again = fm.launch(x, w, b, plan)
    want = fm.fused_matmul_plain(x, w, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _err(got, want) <= 3e-2


@pytest.mark.parametrize("m,t,d,f", [(32, 128, 768, 3072), (16, 128, 768, 1536),
                                     (3, 77, 768, 3072), (4, 4, 64, 77)])
def test_fused_matmul_kernel_bit_identical(dev, m, t, d, f):
    """Two calls give the same bits: the wide variant at both widths (132
    blocks over 384 tiles of 256 columns; 96 tiles of 256; 72 of 128), the
    element-wise kernel (F = 77)."""
    x, w, b = _matmul_inputs(dev, torch.bfloat16, m, t, d, f, True)
    got, again = fm.fused_matmul_cuda(x, w, b), fm.fused_matmul_cuda(x, w, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def _chunk_inputs(dev, dt, lanes, c, h, kvh, sc, hd, offs, seed=8):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(lanes, 1, c, h, hd, generator=g, device=dev).to(dt)
    k = torch.randn(lanes, 1, sc + c, kvh, hd, generator=g, device=dev).to(dt)
    v = torch.randn(lanes, 1, sc + c, kvh, hd, generator=g, device=dev).to(dt)
    off = torch.tensor(offs, dtype=torch.int32, device=dev)[:, None]
    return q, k, v, off


@pytest.mark.parametrize("hd", [8, 64, 128])
@pytest.mark.parametrize("pin,win,sink", [(0, 0, 0), (0, 300, 0), (16, 300, 16)])
def test_chunk_prefill_kernel_split(dev, hd, pin, win, sink):
    """bf16 keys split over a cluster of 8 blocks (17 tiles: 2 or 3
    each): an all-junk lane (offset 0, empty cache), a visible range that
    crosses split boundaries, a ring wrapped once and one wrapped many
    times; two calls bit-identical."""
    lanes, c, h, kvh, sc = 4, 32, 8, 2, 1024
    plan = cpa.launch_plan(lanes, c, h, kvh, hd, sc)
    assert plan.splits == 8 and plan.tiles == 17
    q, k, v, off = _chunk_inputs(dev, torch.bfloat16, lanes, c, h, kvh, sc, hd,
                                 [max(pin, 0), 700, 1500, 5000])
    kw = dict(s_cache=sc, pin=pin, window=win, sink=sink)
    got = cpa.chunk_prefill_attention_cuda(q, k, v, off, **kw)
    again = cpa.chunk_prefill_attention_cuda(q, k, v, off, **kw)
    want = cpa.chunk_prefill_attention_plain(q, k, v, off, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _err(got, want) <= 3e-2


@pytest.mark.parametrize("sc,pin,win", [(1152, 128, 1024), (1536, 0, 1 << 30)])
def test_chunk_prefill_kernel_split_hymba(dev, sc, pin, win):
    """Hymba's G = 5 (H 25 / KVH 5, 160 rows per kv head: a part-full row
    block) at the serve shape, the SWA group (pin = sink = 128, window
    1024) and the global one, keys split over 5 blocks; two calls
    bit-identical."""
    lanes, c, h, kvh, hd = 4, 32, 25, 5, 64
    assert cpa.launch_plan(lanes, c, h, kvh, hd, sc).splits == 5
    q, k, v, off = _chunk_inputs(dev, torch.bfloat16, lanes, c, h, kvh, sc, hd,
                                 [pin, 600, 1300, 2900], seed=9)
    kw = dict(s_cache=sc, pin=pin, window=win, sink=128)
    got = cpa.chunk_prefill_attention_cuda(q, k, v, off, **kw)
    again = cpa.chunk_prefill_attention_cuda(q, k, v, off, **kw)
    want = cpa.chunk_prefill_attention_plain(q, k, v, off, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _err(got, want) <= 3e-2


# the sLSTM cell's launch plans at xlstm-1.3b's head width (hd 512), each
# variant: (dt, rdt, m, b, s) -> a cluster of 16 holding r whole (f32 r, s
# > 1), everything streamed (s = 1), registers + shared memory only at 8
# (bf16 r), registers + shared memory + rows streamed from L2 in two lane
# passes (b = 6)
SLSTM_PLANS = [
    (torch.bfloat16, torch.float32, 4, 1, 32), (torch.float32, torch.float32, 2, 1, 32),
    (torch.bfloat16, torch.float32, 4, 4, 1), (torch.float32, torch.float32, 2, 4, 1),
    (torch.bfloat16, torch.bfloat16, 4, 1, 32), (torch.bfloat16, torch.bfloat16, 4, 4, 1),
    (torch.bfloat16, torch.float32, 1, 6, 5), (torch.float32, torch.bfloat16, 2, 2, 3),
]


@pytest.mark.parametrize("dt,rdt,m,b,s", SLSTM_PLANS)
def test_slstm_cell_kernel_plans(dev, dt, rdt, m, b, s):
    """Every plan variant at hd 512 against the plain version, junk steps
    and a lane frozen by ``alive`` included; two calls bit-identical."""
    h, hd = 2, 512
    p = sc.launch_plan(m, b, s, h, hd, str(rdt).removeprefix("torch."))
    pre, r, state = _cell(dev, dt, rdt, m, b, s, h, hd, seed=5)
    alive = torch.ones(m, b, dtype=torch.bool, device=dev)
    alive[0, 0] = False
    want_st = tuple(t.clone() for t in state)
    want_hs, _ = sc.slstm_cell_plain(pre, r, want_st, num_heads=h, alive=alive)
    outs = []
    for _ in range(2):
        st = tuple(t.clone() for t in state)
        outs.append((sc.slstm_cell_cuda(pre, r, st, num_heads=h, alive=alive)[0], st))
    torch.cuda.synchronize()
    (got_hs, got_st), (again_hs, again_st) = outs
    assert _err(got_hs, want_hs) <= _tol(dt), p
    for gt, wt, name in zip(got_st, want_st, "cnhm"):
        assert _err(gt, wt) <= _tol(dt), (name, p)
        assert torch.equal(gt[0, 0], state["cnhm".index(name)][0, 0]), name
    assert torch.equal(got_hs, again_hs)
    assert all(torch.equal(a, b_) for a, b_ in zip(got_st, again_st))


@pytest.mark.parametrize("hd,s", [(32, 4), (512, 32), (512, 1)])
def test_slstm_cell_kernel_rows(dev, hd, s):
    """``rows`` reads r's instances in place: equal, bit for bit, to the
    call on the gathered copy of r."""
    m, b, h = 4, 1 if s > 1 else 2, 2
    pre, r, state = _cell(dev, torch.bfloat16, torch.float32, m, b, s, h, hd, seed=6)
    r3 = r[:3].contiguous()
    rows = torch.tensor([2, 0, 2, 1], dtype=torch.int32, device=dev)
    st_map = tuple(t.clone() for t in state)
    st_cat = tuple(t.clone() for t in state)
    hs_map, _ = ops.slstm_cell(pre, r3, st_map, num_heads=h, rows=rows)
    hs_cat, _ = ops.slstm_cell(pre, r3.index_select(0, rows.long()).contiguous(), st_cat,
                               num_heads=h)
    torch.cuda.synchronize()
    assert torch.equal(hs_map, hs_cat)
    assert all(torch.equal(a, b_) for a, b_ in zip(st_map, st_cat))
    want = tuple(t.clone() for t in state)
    want_hs, _ = sc.slstm_cell_plain(pre, r3, want, num_heads=h, rows=rows)
    assert _err(hs_map, want_hs) <= 3e-2


def test_slstm_cell_kernel_clusters_resident(dev):
    """Decode's 16 clusters of 8 (two CTAs to an SM) are all resident at
    once; prefill's clusters of 16 one-SM CTAs run in waves, at least 6 at
    a time."""
    for m, b, s, least in ((4, 1, 32, 6), (4, 4, 1, 16)):
        p = sc.launch_plan(m, b, s, 4, 512, "float32")
        assert sc.max_active_clusters(p, b, 512, "bfloat16", "float32") >= least, p


# the wgmma path of the decode layer: (m, b, d, h, kvh, hd, ff, bias) ->
# N = 8 and 16, k split over a cluster (d 512: few tiles), k not a
# multiple of the 64-deep step (d 200), a half tile (kv segment of 64)
TC_LAYERS = [
    (2, 3, 512, 4, 2, 64, 384, True), (2, 12, 512, 4, 2, 64, 384, False),
    (1, 4, 200, 4, 1, 64, 136, True), (3, 16, 256, 8, 1, 32, 512, False),
    (2, 4, 2048, 16, 2, 64, 2816, False), (2, 24, 512, 4, 2, 64, 384, True),
]


@pytest.mark.parametrize("m,b,d,h,kvh,hd,ff,bias", TC_LAYERS)
def test_decode_layer_kernel_tc(dev, m, b, d, h, kvh, hd, ff, bias):
    """The wgmma path (bf16; 24 lanes: two lane groups) against the plain version: the
    whole layer, both phases alone; two calls bit-identical."""
    plans = dl.layer_plans(m, b, d, h, kvh, hd, ff)
    assert plans is not None
    lp, x, ck, cv = _layer(dev, torch.bfloat16, m, b, d, h, kvh, hd, ff, 300, bias)
    pos = (290 + torch.arange(m * b, device=dev, dtype=torch.int32)).reshape(m, b)
    kw = dict(num_heads=h, head_dim=hd, rope_theta=10000.0)
    want = dl.decode_layer_plain(lp, x, ck.clone(), cv.clone(), pos, **kw)
    got = dl.decode_layer_cuda(lp, x, ck.clone(), cv.clone(), pos, **kw)
    again = dl.decode_layer_cuda(lp, x, ck.clone(), cv.clone(), pos, **kw)
    torch.cuda.synchronize()
    for gt, wt, name in zip(got, want, ("x", "k", "v")):
        assert _err(gt, wt) <= 3e-2, (name, plans)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    part = dl.decode_layer_attn_cuda(lp, x, ck.clone(), cv.clone(), pos, **kw)[0]
    want_part = dl.decode_layer_attn_plain(lp, x, ck.clone(), cv.clone(), pos, **kw)[0]
    ffn = [lp[k] for k in ("mlp_norm", "w_gate", "w_up", "w_down")]
    torch.cuda.synchronize()
    assert _part_err(part, want_part) <= 3e-2
    assert _part_err(dl.ffn_cuda(x, *ffn), dl.ffn_plain(x, *ffn)) <= 3e-2


def test_decode_layer_kernel_more_lanes_keep_lanes_matvec(dev):
    """Past 16 lanes per instance f32 keeps the lanes matvec and bf16
    takes the wgmma path in groups of 16 lanes: both against the plain
    version."""
    assert dl.layer_plans(1, 20, 64, 4, 2, 16, 96, "float32") is None
    assert dl.layer_plans(1, 20, 64, 4, 2, 16, 96)["qkv"].groups == 2
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        lp, x, ck, cv = _layer(dev, dt, 1, 20, 64, 4, 2, 16, 96, 40, False)
        pos = torch.arange(20, device=dev, dtype=torch.int32).reshape(1, 20)
        kw = dict(num_heads=4, head_dim=16, rope_theta=10000.0)
        want = dl.decode_layer_plain(lp, x, ck.clone(), cv.clone(), pos, **kw)
        got = dl.decode_layer_cuda(lp, x, ck.clone(), cv.clone(), pos, **kw)
        torch.cuda.synchronize()
        assert _err(got[0], want[0]) <= tol, dt


def test_tensor_maps_encoded_once_per_weight(dev):
    """A weight's map is encoded on its first call only."""
    from repro_torch.kernels import build

    lp, x, ck, cv = _layer(dev, torch.bfloat16, 2, 3, 512, 4, 2, 64, 384, 16, False)
    pos = torch.full((2, 3), 7, dtype=torch.int32, device=dev)
    kw = dict(num_heads=4, head_dim=64, rope_theta=10000.0)
    dl.decode_layer_cuda(lp, x, ck, cv, pos, **kw)
    n = build.tensor_maps.encodes
    for _ in range(3):
        dl.decode_layer_cuda(lp, x, ck, cv, pos, **kw)
    w = (torch.randn(2, 64, 256, device=dev) * 0.1).to(torch.bfloat16)
    fm.fused_matmul_cuda(torch.randn(2, 4, 64, device=dev).to(torch.bfloat16), w)
    fm.fused_matmul_cuda(torch.randn(2, 4, 64, device=dev).to(torch.bfloat16), w)
    torch.cuda.synchronize()
    assert build.tensor_maps.encodes == n + 1


# ---------------------------------------------------------------------------
# a lane's result does not depend on who shares its call
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,h,kvh,hd,ff", [(512, 8, 2, 64, 384), (512, 4, 4, 128, 0),
                                           (2048, 16, 2, 64, 2816)])
def test_decode_layer_lane_alone_equals_its_row(dev, d, h, kvh, hd, ff):
    """bf16: one lane alone (M=1, B=1) equals, bit for bit, its row of an
    M=4 x B=4, an M=2 x B=4, an M=4 x B=12 (wgmma N 16), an M=4 x B=24 and
    an M=1 x B=32 call (two lane groups): the whole layer (ff > 0) or the
    attention phase alone (ff == 0), output and ring."""
    m, b, s = 4, 32, 300
    lp, x, ck, cv = _layer(dev, torch.bfloat16, m, b, d, h, kvh, hd, ff or 64, s, False, seed=3)
    if not ff:
        lp = {k: lp[k] for k in ("attn_norm", "wq", "wk", "wv", "wo")}
    pos = (s + torch.randint(0, s, (m, b), device=dev)).to(torch.int32)
    kw = dict(num_heads=h, head_dim=hd, rope_theta=10000.0)
    call = dl.decode_layer_cuda if ff else dl.decode_layer_attn_cuda

    def run(ms, bs):
        sub = {k: v[ms].contiguous() for k, v in lp.items()}
        k_, v_ = ck[ms, bs].contiguous(), cv[ms, bs].contiguous()
        return call(sub, x[ms, bs].contiguous(), k_, v_, pos[ms, bs].contiguous(), **kw)[0], k_, v_

    one = run(slice(1, 2), slice(2, 3))
    for ms, bs in ((slice(0, 4), slice(0, 4)), (slice(0, 2), slice(0, 4)),
                   (slice(0, 4), slice(0, 12)), (slice(0, 4), slice(0, 24)),
                   (slice(1, 2), slice(0, 32))):
        got = run(ms, bs)
        torch.cuda.synchronize()
        for a, g in zip(one, got):
            assert torch.equal(a[0, 0], g[1 - ms.start, 2]), (ms, bs)


@pytest.mark.parametrize("h,kvh,hd,sc", [(32, 4, 64, 1024), (16, 16, 128, 1024), (8, 2, 64, 200)])
def test_chunk_prefill_lane_alone_equals_its_row(dev, h, kvh, hd, sc):
    """bf16: one lane alone equals, bit for bit, its row of a 4-lane and a
    2-lane call (the split of its keys reads the shapes only)."""
    g = torch.Generator(device=dev).manual_seed(5)
    c = 32
    r = lambda *shp: torch.randn(shp, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = r(4, 1, c, h, hd), r(4, 1, sc + c, kvh, hd), r(4, 1, sc + c, kvh, hd)
    off = torch.tensor([[10], [150], [sc + 7], [3 * sc]], dtype=torch.int32, device=dev)
    alone = cpa.chunk_prefill_attention_cuda(q[1:2], k[1:2], v[1:2], off[1:2], s_cache=sc)
    for n in (4, 2):
        got = cpa.chunk_prefill_attention_cuda(q[:n], k[:n], v[:n], off[:n], s_cache=sc)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], got[1]), n


@pytest.mark.parametrize("m,d,f,t_one,ts", [(4, 2048, 5632, 1, (4, 12)), (64, 2048, 1024, 1, (4, 12)),
                                            (4, 2048, 1024, 32, (32, 64)),
                                            (64, 2048, 1024, 32, (32,))])
def test_fused_matmul_row_alone_equals_its_row(dev, m, d, f, t_one, ts):
    """bf16: a row of one instance alone (skinny, t_one = 1; wide, one
    instance's 32 rows) equals, bit for bit, its row in calls of m and of
    2 instances and of more rows (wgmma N 8 and 16; wide tiles of 32 and
    64 rows; at m = 64 the wide tiles are 256 columns, alone 128)."""
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(m, max(ts), d, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(m, d, f, generator=g, device=dev) * d ** -0.5).to(torch.bfloat16)
    r0 = 2
    alone = fm.fused_matmul_cuda(x[1:2, :t_one].contiguous() if t_one > 1
                                 else x[1:2, r0:r0 + 1].contiguous(), w[1:2].contiguous())
    want = alone[0, r0 if t_one > 1 else 0]
    for n in (m, 2):
        for t in ts:
            got = fm.fused_matmul_cuda(x[:n, :t].contiguous(), w[:n].contiguous())
            torch.cuda.synchronize()
            assert torch.equal(want, got[1, r0]), (n, t)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-moe-30b-a3b"])
def test_moe_mlp_kernel_path(dev, arch):
    """The MoE FFN on the card (the merged matmul over the (instance,
    expert) pairs, three launches) against the plain path on the CPU:
    bf16 within the bf16 tolerance, f32 within 1e-4."""
    from repro_torch.configs import registry
    from repro_torch.models import moe

    cfg = registry.get_smoke_config(arch).with_(num_instances=2, d_model=256, d_ff=128,
                                                num_experts=16, num_experts_per_tok=4)
    g = torch.Generator().manual_seed(7)
    lp = {"router": torch.randn(2, 256, 16, generator=g) / 16,
          "we_gate": torch.randn(2, 16, 256, 128, generator=g) / 16,
          "we_up": torch.randn(2, 16, 256, 128, generator=g) / 16,
          "we_down": torch.randn(2, 16, 128, 256, generator=g) / 128 ** 0.5}
    x = torch.randn(2, 3, 32, 256, generator=g)
    for dt in (torch.float32, torch.bfloat16):
        want = moe.moe_mlp(cfg, {k: v.to(dt) if k != "router" else v for k, v in lp.items()},
                           x.to(dt))
        ops.reset_launches()
        got = moe.moe_mlp(cfg, {k: (v.to(dt) if k != "router" else v).to(dev)
                                for k, v in lp.items()}, x.to(dt).to(dev))
        torch.cuda.synchronize()
        assert ops.launches()["fused_matmul"] == 3
        assert _err(got.cpu(), want) <= _tol(dt), dt
