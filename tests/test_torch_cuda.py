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
from repro_torch.kernels import decode_layer as dl
from repro_torch.kernels import ops

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
