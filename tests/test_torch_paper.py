"""The paper's evaluation path of the port against the JAX package, on the
CPU: the merged ops of ``core/fused_ops``, the encoders (BERT, XLNet), the
CNNs (ResNet, ResNeXt), the strategy baselines and the benchmark CLI.

Inputs come from a seeded numpy generator; parameters from the
reference's ``init`` on JAX's CPU, carried across with
``checkpoint.bridge.params_from_numpy``.  f32 throughout.  Tolerance
2e-5 relative and absolute (the other port tests' figure): both sides
compute in f32 with the same rounding points, and what is left is
summation order (XLA's matmuls and convolutions against torch's, oneDNN's
batch norm against the reference's x * inv + shift), a few ulps over the
layers.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from repro.configs import registry as jreg
from repro.core import fused_ops as jF
from repro.core import merge as jmerge
from repro.models import cnn as jcnn
from repro.models import encoder as jenc
from repro.models import layers as jL
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.core import baselines
from repro_torch.core import fused_ops as tF
from repro_torch.core import merge as tmerge
from repro_torch.models import cnn as tcnn
from repro_torch.models import common as C
from repro_torch.models import encoder as tenc
from repro_torch.models import layers as tL

TOL = dict(rtol=2e-5, atol=2e-5)
REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "benchmarks"))
import torch_run  # noqa: E402


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _n(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(kw or TOL))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# fused ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bias", [False, True])
def test_batch_matmul_both_forms(bias):
    rng = _rng(1)
    x, w = _n(rng, 3, 2, 5, 8), _n(rng, 3, 8, 6)
    b = _n(rng, 3, 6) if bias else None
    jb, tb = (None, None) if b is None else (jnp.asarray(b), _t(b))
    _close(tF.batch_matmul(_t(x), _t(w), tb), jF.batch_matmul(jnp.asarray(x), jnp.asarray(w), jb))
    xc = x.reshape(3 * 10, 8)
    _close(tF.batch_matmul_concat(_t(xc), _t(w), tb),
           jF.batch_matmul_concat(jnp.asarray(xc), jnp.asarray(w), jb))


@pytest.mark.parametrize("size,stride,k", [(8, 1, 3), (8, 2, 3), (9, 2, 3), (9, 1, 1),
                                           (16, 2, 7), (11, 2, 7), (6, 2, 1)])
@pytest.mark.parametrize("m,card", [(1, 1), (3, 1), (2, 4)])
def test_grouped_conv2d_matches_reference(size, stride, k, m, card):
    """SAME padding at strides 1 and 2 on even and odd sizes (XLA puts the
    odd pixel at the high end), groups = M * cardinality."""
    rng = _rng(2)
    cin, cout = 4 * card, 2 * card
    x = _n(rng, 2, size, size, m * cin)
    w = _n(rng, k, k, cin // card, m * cout, scale=0.3)
    want = jF.grouped_conv2d(jnp.asarray(x), jnp.asarray(w), groups=m * card, stride=stride)
    _close(tF.grouped_conv2d(_t(x), _t(w), groups=m * card, stride=stride), want)


@pytest.mark.parametrize("size", [112, 7, 8])
def test_max_pool_same_matches_reduce_window(size):
    rng = _rng(3)
    x = _n(rng, 2, size, size, 3)
    want = lax.reduce_window(jnp.asarray(x), -jnp.inf, lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                             "SAME")
    got = tF.max_pool_same(_t(x).permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
    _close(got, want, rtol=0, atol=0)


def test_norms_embedding_and_form_conversion():
    rng = _rng(4)
    m, d = 3, 16
    x = _n(rng, 2, 5, m * d, scale=3.0)
    s, b = 1 + _n(rng, m * d, scale=0.1), _n(rng, m * d, scale=0.1)
    _close(tF.group_norm(_t(x), _t(s), _t(b), num_groups=m),
           jF.group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), num_groups=m))
    xi = _n(rng, m, 2, 5, d, scale=3.0)
    si, bi = 1 + _n(rng, m, d, scale=0.1), _n(rng, m, d, scale=0.1)
    _close(tF.merged_layer_norm(_t(xi), _t(si), _t(bi)),
           jF.merged_layer_norm(jnp.asarray(xi), jnp.asarray(si), jnp.asarray(bi)))
    _close(tF.merged_layer_norm(_t(xi), _t(si), None),
           jF.merged_layer_norm(jnp.asarray(xi), jnp.asarray(si), None))
    _close(tL.layer_norm(_t(xi), _t(si), _t(bi)),
           jL.layer_norm(jnp.asarray(xi), jnp.asarray(si), jnp.asarray(bi)))
    mean, var = _n(rng, m * d), 0.5 + rng.random(m * d).astype(np.float32)
    _close(tF.merged_batch_norm(_t(x), _t(mean), _t(var), _t(s), _t(b)),
           jF.merged_batch_norm(*(jnp.asarray(a) for a in (x, mean, var, s, b))))
    ids = rng.integers(0, 11, (m, 2, 5)).astype(np.int32)
    table = _n(rng, m, 11, d)
    _close(tF.merged_embedding(_t(ids), _t(table)),
           jF.merged_embedding(jnp.asarray(ids), jnp.asarray(table)), rtol=0, atol=0)
    xb = _n(rng, m * 2, 5, d)
    _close(tF.batch_to_channel(_t(xb), m), jF.batch_to_channel(jnp.asarray(xb), m),
           rtol=0, atol=0)
    xc = _n(rng, 2, 5, m * d)
    _close(tF.channel_to_batch(_t(xc), m), jF.channel_to_batch(jnp.asarray(xc), m),
           rtol=0, atol=0)
    ws = [_n(rng, 3, 3, 2, 4) for _ in range(m)]
    _close(tF.merge_conv_weights([_t(w) for w in ws]),
           jF.merge_conv_weights([jnp.asarray(w) for w in ws]), rtol=0, atol=0)


def test_gelu_mlp_is_the_tanh_form():
    rng = _rng(5)
    x = _n(rng, 2, 1, 4, 8)
    w1, b1, w2, b2 = _n(rng, 2, 8, 16), _n(rng, 2, 16), _n(rng, 2, 16, 8), _n(rng, 2, 8)
    want = jL.gelu_mlp(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    _close(tL.gelu_mlp(*(_t(a) for a in (x, w1, b1, w2, b2))), want)


def test_instance_axis_helpers():
    rng = _rng(6)
    trees = [{"w": _n(rng, 3, 2), "b": _n(rng, 2)} for _ in range(3)]
    jt = [jax.tree.map(jnp.asarray, t) for t in trees]
    tt = [{k: _t(v) for k, v in t.items()} for t in trees]
    for k in ("w", "b"):
        _close(tmerge.add_instance_axis(tt[0])[k], jmerge.add_instance_axis(jt[0])[k])
        _close(tmerge.concat_instances(tmerge.stack_instances(tt[:2]),
                                       tmerge.stack_instances(tt[2:]))[k],
               jmerge.concat_instances(jmerge.stack_instances(jt[:2]),
                                       jmerge.stack_instances(jt[2:]))[k])


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,xlnet", [("bert-base", False), ("xlnet-base", True)])
def test_encoder_forward_matches_reference(arch, xlnet):
    cfg = jreg.get_smoke_config(arch).with_(num_instances=2)
    jp = jenc.init(cfg, jax.random.PRNGKey(0), xlnet=xlnet)
    if xlnet:       # the reference inits u, v at zero: give them values to check
        rng = _rng(7)
        jp["layers"]["u"] = jnp.asarray(_n(rng, *jp["layers"]["u"].shape, scale=0.5))
        jp["layers"]["v"] = jnp.asarray(_n(rng, *jp["layers"]["v"].shape, scale=0.5))
    tcfg = treg.get_smoke_config(arch).with_(num_instances=2)
    tp = params_from_numpy(tcfg, _np_tree(jp), "cpu")
    assert tp["layers"]["wq"].shape[:2] == (cfg.num_layers, 2)
    tok = _rng(8).integers(0, cfg.vocab_size, (2, 2, 24)).astype(np.int32)
    want = jenc.forward(cfg, jp, jnp.asarray(tok), xlnet=xlnet)
    got = tenc.forward(tcfg, tp, _t(tok), xlnet=xlnet)
    assert got.shape == (2, 2, 24, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("arch", ["resnet50", "resnext50"])
def test_cnn_forward_matches_reference(arch):
    """The smoke configs at 32x32 (stem 7x7/2 pads (2, 3), the pool and
    the stage-2 stride-2 convs pad (0, 1)), M=3 merged instances."""
    cfg = jreg.get_smoke_config(arch).with_(num_instances=3)
    jp = jcnn.init(cfg, jax.random.PRNGKey(1))
    rng = _rng(9)
    # non-trivial batch-norm statistics
    for blk in [jp["stem"]] + [b[k] for s in jp["stages"] for b in s for k in b]:
        c = blk["bn_mean"].shape
        blk["bn_mean"] = jnp.asarray(_n(rng, *c, scale=0.1))
        blk["bn_var"] = jnp.asarray(0.5 + rng.random(c).astype(np.float32))
        blk["bn_scale"] = jnp.asarray(1 + _n(rng, *c, scale=0.1))
    tcfg = treg.get_smoke_config(arch).with_(num_instances=3)
    tp = params_from_numpy(tcfg, _np_tree(jp), "cpu")
    w = tp["stages"][0][0]["conv3"]["w"]
    assert w.reshape(-1, *w.shape[2:]).is_contiguous(memory_format=torch.channels_last)
    img = _n(rng, 3, 2, cfg.image_size, cfg.image_size, 3)
    want = jax.jit(lambda p, x: jcnn.forward(cfg, p, x))(jp, jnp.asarray(img))
    got = tcnn.forward(tcfg, tp, _t(img))
    assert len(got) == 3 and got[0].shape == (2, cfg.num_classes)
    for g, w_ in zip(got, want):
        _close(g, w_, rtol=2e-5, atol=5e-5)


@pytest.mark.parametrize("arch", ["resnext50", "bert-base"])
def test_strategies_agree_and_merged_equals_per_instance(arch):
    """sequential, concurrent, hybrid(P=2), netfuse (merging inside the
    call) and the premerged call return the same per-instance outputs, and
    they equal each instance run alone."""
    cfg = treg.get_smoke_config(arch).with_(num_instances=1)
    rng = _rng(10)
    if cfg.family == "cnn":
        apply_fn = lambda p, x: torch.stack(tcnn.forward(cfg, p, x))
        make = lambda g: tcnn.init(cfg, g, "cpu")
        inputs = [_t(_n(rng, 1, cfg.image_size, cfg.image_size, 3)) for _ in range(5)]
    else:
        apply_fn = lambda p, x: tenc.forward(cfg, p, x)
        make = lambda g: tenc.init(cfg, g, "cpu")
        inputs = [_t(rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int64))
                  for _ in range(5)]
    ones = [make(torch.Generator().manual_seed(i)) for i in range(5)]
    merged = C.merge_instances(ones)
    x = torch.stack(inputs)
    seq = baselines.sequential(apply_fn, ones, inputs)
    outs = {
        "concurrent": baselines.concurrent(apply_fn, ones, inputs),
        "hybrid": baselines.hybrid(apply_fn, ones, inputs, num_concurrent=2),
        "netfuse": baselines.netfuse(apply_fn, ones, inputs),
        "premerged": list(baselines.netfuse_premerged(apply_fn, merged, x)),
        "alone": [apply_fn(ones[i], inputs[i][None])[0] for i in range(5)],
    }
    # the callables the benchmark times, on views of the merged model
    views = torch_run.instances(merged, 5)
    for name, fn in torch_run.strategies(apply_fn, views, merged, x, x.device,
                                         hybrid=(2,)).items():
        outs[f"timed/{name}"] = list(fn())
    for name, out in outs.items():
        assert len(out) == 5, name
        for a, b in zip(seq, out):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL, err_msg=name)
    assert set(baselines.STRATEGIES) == {"sequential", "concurrent", "netfuse"}


def test_bench_cli_tab_exact_on_cpu():
    """``benchmarks/torch_run.py tab_exact`` at bench scale on the CPU:
    merged == per-instance for the four models, one CSV row each."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, str(REPO / "benchmarks" / "torch_run.py"), "--smoke",
                        "--device", "cpu", "--only", "tab_exact"],
                       capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    rows = [l.split(",") for l in r.stdout.splitlines()
            if l.startswith("tab_exact/") and "/max_abs_diff," in l]
    assert [row[0].split("/")[1] for row in rows] == ["resnet50", "resnext50", "bert", "xlnet"]
    for row in rows:
        assert float(row[2]) <= 1e-4, row


def test_bench_cli_refuses_without_a_card():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), CUDA_VISIBLE_DEVICES="")
    for script, flag in (("torch_run.py", "--smoke"), ("torch_roofline_table.py", "--achieved")):
        r = subprocess.run([sys.executable, str(REPO / "benchmarks" / script), flag],
                           capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
        assert r.returncode != 0 and "no CUDA device" in r.stderr, (script, r.stderr[-500:])
