"""The port's training substrate and whole-sequence entry points against
the JAX package on the CPU.

Both packages get the same weights: ``repro.api.init`` on JAX's CPU,
carried across with ``checkpoint.bridge.params_from_numpy`` and made
trainable (``common.training_params``: f32 master weights that require a
gradient).  f32 smoke configs at M = 2; one jitted JAX ``value_and_grad``
per family.  Tolerances:

* ``train_logits``, ``loss_fn``, ``prefill``'s last logits and every
  cache / state leaf: 1e-5 (both sides in f32 with the same rounding
  points; summation order is what is left);
* every gradient leaf within 1e-4 of that leaf's largest magnitude
  (summation order through the backward of a whole model);
* ``remat=True`` against ``remat=False``: bit for bit;
* AdamW and SGD-momentum on the reference's own gradients: 1e-6 over 3
  steps; ``train_loop``'s loss trajectory over 5 steps: 1e-4 relative.
  Parameters after a full train step are not compared elementwise: step 1
  of AdamW is nearly sign(g) * lr, so a gradient near 0 flips by 2 lr on
  a last-bit difference.

The mLSTM and sLSTM kernels are differentiated through autograd Functions
(``kernels/mlstm_chunk.Chunkwise``, ``kernels/slstm_cell.Scan``); on the
CPU their forward is the plain version, so the whole-model gradients here
hold the Functions' backward against ``jax.grad``.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as japi
from repro import checkpoint as jckpt
from repro.configs import registry as jreg
from repro.data import pipeline as jpipe
from repro.kernels import ref
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro.train import loop as jloop
from repro_torch import api as tapi
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import mlstm_chunk as ml
from repro_torch.kernels import ops
from repro_torch.kernels import slstm_cell as sc
from repro_torch.launch import train as tlaunch
from repro_torch.models import common as C
from repro_torch.models import ssm as tssm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedules as tsched
from repro_torch.train import loop as tloop

TOL = dict(rtol=1e-5, atol=1e-5)
# hymba-smoke at 4 layers, as ``tests/test_torch_hybrid.py`` holds its chain:
# each block adds ~5e-6 of summation-order noise to the residual stream
TOL_CHAIN = dict(rtol=5e-5, atol=5e-5)
M, B, S = 2, 2, 16
ARCHS = ("tinyllama-1.1b", "xlstm-1.3b", "hymba-1.5b")


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x, np.float32)


def _walk(fn, got, want, path=""):
    """``fn(path, got leaf, want leaf)`` over a port tree and a reference
    tree of the same structure (dicts, lists, NamedTuples, ``None``)."""
    if got is None:
        assert want is None, path
    elif isinstance(got, dict):
        assert sorted(got) == sorted(want), path
        for k in got:
            _walk(fn, got[k], want[k], f"{path}.{k}")
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _walk(fn, g, w, f"{path}[{i}]")
    else:
        fn(path, got, want)


def _close(path, got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want), err_msg=path, **tol)


def _grad_close(path, got, want, tol=1e-4):
    want = _np(want)
    assert got is not None, path
    err = np.abs(got.numpy() - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (path, err, np.abs(want).max())


_FAM = {}


def _family(arch):
    """(jcfg, tcfg, JAX params, numpy tree, JAX batch, torch batch, JAX
    (loss, metrics, logits), JAX grads): one jitted value_and_grad."""
    if arch not in _FAM:
        # the reference without remat: the same numbers, a shorter compile
        jcfg = jreg.get_smoke_config(arch).with_(num_instances=M, remat=False)
        tcfg = treg.get_smoke_config(arch).with_(num_instances=M)
        jp = japi.init(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jp)
        toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (M, B, S + 1)).astype(
            np.int32)
        jb = {"tokens": jnp.asarray(toks[..., :-1]), "labels": jnp.asarray(toks[..., 1:])}
        tb = {"tokens": torch.from_numpy(toks[..., :-1].copy()),
              "labels": torch.from_numpy(toks[..., 1:].copy())}

        def loss(p):
            l, met = japi.loss_fn(jcfg, p, jb)
            return l, (met, japi.train_logits(jcfg, p, jb))

        (jl, (jm, jlog)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
        _FAM[arch] = (jcfg, tcfg, jp, tree, jb, tb, (jl, jm, jlog), jg)
    return _FAM[arch]


def _trainable(tcfg, tree):
    return C.training_params(tcfg, params_from_numpy(tcfg, tree, "cpu"))


def _port_grads(tcfg, tree, tb, remat=None):
    p = _trainable(tcfg, tree)
    cfg = tcfg if remat is None else tcfg.with_(remat=remat)
    loss, met = tapi.loss_fn(cfg, p, tb)
    loss.backward()
    return p, loss, met


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_loss_and_grads_match_reference(arch):
    jcfg, tcfg, jp, tree, jb, tb, (jl, jm, jlog), jg = _family(arch)
    p, loss, met = _port_grads(tcfg, tree, tb)
    with torch.no_grad():
        logits = tapi.train_logits(tcfg, p, tb)
    assert logits.shape == (M, B, S, tcfg.vocab_size) and logits.dtype == torch.float32
    _close("logits", logits, jlog)
    _close("loss", loss, jl)
    _close("nll", met["nll"], jm["nll"])
    _close("aux", met["aux"], jm["aux"])
    missing = [n for n, q in p.named_parameters() if q.grad is None]
    assert not missing, missing
    _walk(_grad_close, p.tree("grad"), jax.tree.map(np.asarray, jg), "grad")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_loss_and_grads_bit_for_bit(arch):
    _, tcfg, _, tree, _, tb, _, _ = _family(arch)
    p1, l1, _ = _port_grads(tcfg, tree, tb, remat=True)
    p0, l0, _ = _port_grads(tcfg, tree, tb, remat=False)
    assert torch.equal(l1, l0)
    _walk(lambda path, a, b: torch.equal(a, b) or pytest.fail(path),
          p1.tree("grad"), p0.tree("grad"))


def _long_hybrid_prompt(layers=4, s=48):
    """hymba-smoke at 4 layers (the 2-layer smoke config has no SWA layer)
    with a prompt longer than its SWA ring (window 32): the whole prefill
    puts the prompt's last ring-width positions at their ring slots."""
    jcfg = jreg.get_smoke_config("hymba-1.5b").with_(num_instances=M, num_layers=layers,
                                                     remat=False)
    tcfg = treg.get_smoke_config("hymba-1.5b").with_(num_instances=M, num_layers=layers)
    assert s > tcfg.sliding_window
    jp = japi.init(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (M, B, s)).astype(np.int32)
    return jcfg, tcfg, jp, jax.tree.map(np.asarray, jp), toks


@pytest.mark.parametrize("arch", [*ARCHS, pytest.param("hymba-1.5b", id="hymba-1.5b-swa-ring")])
def test_prefill_matches_reference_and_decode_continues(arch, request):
    """Whole-sequence prefill: last logits and every cache / state leaf
    within 1e-5; then 4 greedy decode steps from it give the reference's
    tokens.  The ``swa-ring`` case's prompt is longer than hymba's SWA
    ring, so a decode step reads keys the prefill rotated into the ring;
    at 4 layers it is held at ``TOL_CHAIN`` (a misplaced ring slot is off
    by O(1))."""
    tol = TOL
    if request.node.callspec.id.endswith("swa-ring"):
        jcfg, tcfg, jp, tree, toks = _long_hybrid_prompt()
        tol = TOL_CHAIN
    else:
        jcfg, tcfg, jp, tree, jb, _, _, _ = _family(arch)
        toks = np.asarray(jb["tokens"])
    close = lambda path, got, want: _close(path, got, want, tol)
    s = toks.shape[2]
    tp = params_from_numpy(tcfg, tree, "cpu")
    jlog, jcache = jax.jit(lambda p, t: japi.prefill(jcfg, p, {"tokens": t}))(
        jp, jnp.asarray(toks))
    tlog, tcache = tapi.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks.copy())},
                                cache_len=s + 4)
    close("logits", tlog, jlog)
    if arch == "tinyllama-1.1b":
        # the reference's default cache is the prompt; the port's, asked for
        # 4 more slots, holds it in its first S
        jcache = type(jcache)(*(np.pad(np.asarray(t), [(0, 0)] * 3 + [(0, 4)] + [(0, 0)] * 2)
                                for t in jcache))
    _walk(close, tcache, jcache, "cache")
    pos0 = s + tapi.prefill_prefix_len(tcfg)
    jdec = jax.jit(lambda c, t, pos: japi.decode_step(jcfg, jp, c, t, pos))
    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    ttok = torch.argmax(tlog, -1).to(torch.int32)
    for t in range(4):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok), err_msg=f"step {t}")
        pos = np.full((M, B), pos0 + t, np.int32)
        jl_, jcache = jdec(jcache, jtok[..., None], jnp.asarray(pos))
        with torch.no_grad():
            tl_, tcache = tapi.decode_step(tcfg, tp, tcache, ttok[..., None],
                                           torch.from_numpy(pos))
        close(f"decode logits {t}", tl_, jl_)
        jtok = jnp.argmax(jl_, -1).astype(jnp.int32)
        ttok = torch.argmax(tl_, -1).to(torch.int32)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def _mlstm_inputs(seed, m=2, b=1, h=2, s=12, hd=8):
    g = np.random.default_rng(seed)
    qkv = [g.standard_normal((m, b, h, s, hd), np.float32) for _ in range(3)]
    gates = g.standard_normal((2, m, b, h, s), np.float32)
    lf = np.log(1 / (1 + np.exp(-gates[0]))).astype(np.float32)
    return qkv + [lf, gates[1]]


def _slstm_inputs(seed, m=2, b=2, s=7, h=2, hd=4):
    g = np.random.default_rng(seed)
    d = h * hd
    pre = g.standard_normal((m, b, s, 4, d), np.float32)
    r = g.standard_normal((m, 4, h, hd, hd), np.float32) / np.sqrt(hd)
    st = [g.standard_normal((m, b, d), np.float32) * 0.1 for _ in range(3)]
    st.append(np.zeros((m, b, d), np.float32))
    st[1] = np.abs(st[1]) + 0.5          # n > 0
    return pre, r, tuple(st)


def test_mlstm_function_grads_match_reference_math():
    """``Chunkwise`` with the plain version as its forward: its gradients
    (h, C, n and m all carrying a cotangent) equal autograd through the
    port's chunkwise scan and ``jax.vjp`` of the reference's oracle."""
    arrs = _mlstm_inputs(2)
    cot = _mlstm_inputs(3)[:1] + [np.random.default_rng(4).standard_normal(
        (2, 1, 2, 8, 8), np.float32), np.random.default_rng(5).standard_normal(
        (2, 1, 2, 8), np.float32), np.random.default_rng(6).standard_normal((2, 1, 2),
                                                                           np.float32)]
    ins = [torch.from_numpy(a).requires_grad_() for a in arrs]
    h, (Cs, n, m) = ml.mlstm_chunkwise_grad(ml.mlstm_chunkwise_plain, *ins, chunk=4)
    assert h.grad_fn is not None and Cs.grad_fn is not None
    got = torch.autograd.grad((h, Cs, n, m), ins, [torch.from_numpy(c) for c in cot])

    ins2 = [torch.from_numpy(a).requires_grad_() for a in arrs]
    h2, st2 = tssm.mlstm_sequence(*ins2, ml.zero_state(ins2[0]), chunk=4)
    want_port = torch.autograd.grad((h2,) + st2, ins2, [torch.from_numpy(c) for c in cot])
    _, vjp = jax.vjp(lambda *a: (lambda h_, st: (h_,) + st)(*ref.mlstm_chunkwise(*a, chunk=4)),
                     *[jnp.asarray(a) for a in arrs])
    want_jax = vjp(tuple(jnp.asarray(c) for c in cot))
    for i, (g_, wp, wj) in enumerate(zip(got, want_port, want_jax)):
        np.testing.assert_allclose(g_.numpy(), wp.numpy(), err_msg=str(i), **TOL)
        np.testing.assert_allclose(g_.numpy(), _np(wj), err_msg=str(i), **TOL)


def test_slstm_function_grads_match_reference_math():
    """``Scan`` with the plain version as its forward: gradients to pre, r
    and the initial state equal autograd through ``ssm.slstm_scan`` and
    ``jax.vjp`` of the reference's oracle; the state passed in is not
    written."""
    pre, r, st = _slstm_inputs(7)
    g = np.random.default_rng(8)
    cot = [g.standard_normal(pre.shape[:3] + pre.shape[4:], np.float32)] + [
        g.standard_normal(st[0].shape, np.float32) for _ in range(4)]
    ins = [torch.from_numpy(a).requires_grad_() for a in (pre, r) + st]
    before = [t.detach().clone() for t in ins[2:]]
    hs, new = sc.slstm_cell_grad(sc.slstm_cell_plain, ins[0], ins[1], tuple(ins[2:]),
                                 num_heads=2)
    assert all(torch.equal(a, b) for a, b in zip(ins[2:], before))
    got = torch.autograd.grad((hs,) + new, ins, [torch.from_numpy(c) for c in cot])

    ins2 = [torch.from_numpy(a).requires_grad_() for a in (pre, r) + st]
    hs2, new2 = tssm.slstm_scan(ins2[0], ins2[1], tuple(ins2[2:]), 2)
    want_port = torch.autograd.grad((hs2,) + new2, ins2, [torch.from_numpy(c) for c in cot])
    _, vjp = jax.vjp(lambda p, rr, *s_: (lambda h_, s2: (h_,) + s2)(
        *ref.slstm_cell(p, rr, s_, num_heads=2)), *[jnp.asarray(a) for a in (pre, r) + st])
    want_jax = vjp(tuple(jnp.asarray(c) for c in cot))
    for i, (g_, wp, wj) in enumerate(zip(got, want_port, want_jax)):
        np.testing.assert_allclose(g_.numpy(), wp.numpy(), err_msg=str(i), **TOL)
        np.testing.assert_allclose(g_.numpy(), _np(wj), err_msg=str(i), **TOL)


def test_mlstm_grads_stay_finite_under_strong_forget_gates():
    """Forget gates summing below -88 over a chunk make the chunk's decay
    matrix overflow above its diagonal; the masked entries must not turn
    the gradient into NaN (the exp takes the mask first)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 1, 2, 256, 64, generator=g).requires_grad_() for _ in range(3))
    lf = torch.nn.functional.logsigmoid(torch.randn(1, 1, 2, 256, generator=g) - 6)
    li = torch.randn(1, 1, 2, 256, generator=g) * 3
    assert float(lf.sum(-1).max()) < -200
    lf, li = lf.requires_grad_(), li.requires_grad_()
    h, _ = ml.mlstm_chunkwise_grad(ml.mlstm_chunkwise_plain, q, k, v, lf, li, chunk=128)
    h.float().square().sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v, lf, li))


class _CudaProbe:
    """A stand-in whose ``.device`` is CUDA: what a kernel wrapper reads
    to choose the kernel's launch over the plain version."""
    device = torch.device("cuda")


def test_kernel_launch_without_a_function_raises_under_autograd(monkeypatch):
    """A CUDA launch of a kernel with no autograd Function (the sharded
    merged matmul), on an input that requires a gradient, raises instead
    of returning a tensor cut off the graph; without a gradient it
    launches.  A kernel with a Function launches under it and counts its
    launches: the merged matmul's forward once and its backward twice (dx
    and dw)."""
    x = torch.randn(2, 3, 8, requires_grad=True)
    w = torch.randn(2, 8, 5)
    launched = []
    plain = lambda *a, **k: launched.append(1) or ops._fm.fused_matmul_plain(*a, **k)
    monkeypatch.setattr(ops._fused_matmul_sh, "cuda", plain)
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="no backward"):
        ops._fused_matmul_sh(_CudaProbe(), x, w, None)
    assert not launched and ops.launches()["fused_matmul_sharded"] == 0
    with torch.no_grad():
        ops._fused_matmul_sh(_CudaProbe(), x, w, None)
    assert launched and ops.launches()["fused_matmul_sharded"] == 1

    monkeypatch.setattr(ops._fused_matmul, "cuda", plain)
    wg = w.clone().requires_grad_()
    y = ops._fused_matmul(_CudaProbe(), x, wg, None)
    assert y.grad_fn is not None and ops.launches()["fused_matmul"] == 1
    y.sum().backward()
    assert x.grad is not None and wg.grad is not None
    assert ops.launches()["fused_matmul"] == 3

    monkeypatch.setattr(ops._mlstm, "cuda", ml.mlstm_chunkwise_plain)
    q, k, v, lf, li = [torch.from_numpy(a).requires_grad_() for a in _mlstm_inputs(9)]
    h, _ = ops._mlstm(_CudaProbe(), q, k, v, lf, li, chunk=4)
    assert h.grad_fn is not None and ops.launches()["mlstm_chunkwise"] == 1
    h.sum().backward()
    assert all(t.grad is not None for t in (q, k, v, lf, li))
    ops.reset_launches()


def test_adamw_and_sgdm_match_reference_on_its_gradients():
    """Three steps of each optimizer from the same params, state and
    (the reference's) gradients; params and moments within 1e-6.  The
    smoke gradients' global norm is above 1, so the clip is active; a
    second run at max_grad_norm 1e3 leaves it off."""
    _, tcfg, jp, tree, _, _, _, jg = _family("tinyllama-1.1b")
    tg = jax.tree.map(lambda g: torch.from_numpy(np.array(g)), jg)
    for max_norm in (1.0, 1e3):
        j_adamw = jax.jit(lambda g, st, p: jadamw.adamw_update(g, st, p, lr=1e-2,
                                                               max_grad_norm=max_norm))
        j_sgdm = jax.jit(lambda g, st, p: jadamw.sgdm_update(g, st, p, lr=1e-2,
                                                             max_grad_norm=max_norm))
        jparams, tparams = jp, _trainable(tcfg, tree)
        jst, tst = jadamw.adamw_init(jparams), tadamw.adamw_init(tparams)
        jsg, tsg = jadamw.sgdm_init(jparams), tadamw.sgdm_init(tparams)
        jparams2, tparams2 = jp, _trainable(tcfg, tree)
        for step in range(3):
            scale = 0.5 + step
            jgs = jax.tree.map(lambda g: g * scale, jg)
            tgs = C.tree_map(lambda g: g * scale, tg)
            jparams, jst, jm = j_adamw(jgs, jst, jparams)
            tparams, tst, tm = tadamw.adamw_update(tgs, tst, tparams, lr=1e-2,
                                                   max_grad_norm=max_norm)
            np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                       rtol=1e-6)
            jparams2, jsg, _ = j_sgdm(jgs, jsg, jparams2)
            tparams2, tsg, _ = tadamw.sgdm_update(tgs, tsg, tparams2, lr=1e-2,
                                                  max_grad_norm=max_norm)
        assert tst.step == int(jst.step) == 3
        tol = lambda path, a, b: np.testing.assert_allclose(
            a.detach().numpy(), _np(b), rtol=1e-6, atol=1e-6, err_msg=path)
        _walk(tol, tparams.tree(), jparams, "adamw")
        _walk(tol, tst.mu, jst.mu, "mu")
        _walk(tol, tst.nu, jst.nu, "nu")
        _walk(tol, tparams2.tree(), jparams2, "sgdm")
        _walk(tol, tsg.mu, jsg.mu, "sgdm mu")


def test_train_loop_loss_trajectory_matches_reference():
    """Five steps of ``train_loop`` from the same weights on the same
    stream: every loss within 1e-4 relative."""
    jcfg = jreg.get_smoke_config("tinyllama-1.1b").with_(vocab_size=64, num_instances=2)
    tcfg = treg.get_smoke_config("tinyllama-1.1b").with_(vocab_size=64, num_instances=2)
    jp = japi.init(jcfg, jax.random.PRNGKey(3))
    tp = _trainable(tcfg, jax.tree.map(np.asarray, jp))
    kw = dict(steps=5, batch_size=2, seq_len=16, log_every=1, print_fn=lambda *_: None)
    _, jlosses = jloop.train_loop(jcfg, jpipe.SyntheticLM(64, 2, seed=5),
                                  lr_schedule=jsched.cosine_with_warmup(3e-3, 2, 5),
                                  state=jloop.TrainState(jp, jadamw.adamw_init(jp)), **kw)
    _, tlosses = tloop.train_loop(tcfg, tpipe.SyntheticLM(64, 2, seed=5),
                                  lr_schedule=tsched.cosine_with_warmup(3e-3, 2, 5),
                                  state=tloop.TrainState(tp, tadamw.adamw_init(tp)), **kw)
    assert [s for s, _ in tlosses] == [s for s, _ in jlosses] == list(range(5))
    np.testing.assert_allclose([l for _, l in tlosses], [l for _, l in jlosses], rtol=1e-4)


def test_train_loop_loss_decreases():
    """The port's counterpart of the reference's test: 60 steps on a
    tiny model cut the loss well below where it starts."""
    cfg = treg.get_smoke_config("tinyllama-1.1b").with_(vocab_size=64)
    data = tpipe.SyntheticLM(cfg.vocab_size, 1, seed=0)
    _, losses = tloop.train_loop(cfg, data, steps=60, batch_size=4, seq_len=32,
                                 lr_schedule=tsched.cosine_with_warmup(3e-3, 10, 200),
                                 log_every=20, device="cpu", print_fn=lambda *_: None)
    first, last = losses[0][1], losses[-1][1]
    assert last < first - 0.2, (first, last)


def test_microbatches_average_the_gradients():
    """Two microbatches of B/2 give the loss and the step of one batch of
    B (the mean of equal-sized means), within float noise."""
    _, tcfg, _, tree, _, tb, _, _ = _family("tinyllama-1.1b")
    out = []
    for mb in (1, 2):
        p = _trainable(tcfg, tree)
        st, met = tloop.make_train_step(tcfg, lr_schedule=tsched.constant(1e-3),
                                        microbatches=mb)(
            tloop.TrainState(p, tadamw.adamw_init(p)), tb)
        out.append((float(met["loss"]), st.opt.mu))
    np.testing.assert_allclose(out[1][0], out[0][0], **TOL)
    _walk(lambda path, a, b: np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                                        atol=1e-7, err_msg=path),
          out[1][1], out[0][1], "mu")


def test_instance_isolation_in_merged_training():
    """``examples/train_merged.py`` on the port, with AdamW's global clip
    (the one coupling of the instances) off: M = 3 instances trained
    fused for 10 steps, each on its own stream.  Instance 0 must not see
    the other instances' data: the run again with instances 1 and 2 on
    other streams leaves it within 1e-5 (summation order).  Against
    instance 0 trained alone on its stream, 1e-3 (the fused loss averages
    over M, so its gradients are the solo run's / M and AdamW's eps acts
    on the tiniest of them).  Instance 0 fed instance 1's stream moves
    its weights by ~2e-2 in either comparison."""
    cfg1 = treg.get_smoke_config("tinyllama-1.1b").with_(vocab_size=64)
    cfg = cfg1.with_(num_instances=3)
    kw = dict(steps=10, batch_size=4, seq_len=32, lr_schedule=tsched.constant(1e-3),
              log_every=10, print_fn=lambda *_: None, max_grad_norm=math.inf)

    def singles():
        return [tapi.init(cfg1, torch.Generator().manual_seed(i), "cpu", train=True)
                for i in range(3)]

    def fused(seeds):
        merged = C.training_params(cfg, C.merge_instances([p.tree() for p in singles()]))
        streams = [tpipe.SyntheticLM(64, 1, seed=s) for s in seeds]

        def data(step):
            bs = [st.batch(step, 4, 32) for st in streams]
            return {k: torch.cat([x[k] for x in bs]) for k in bs[0]}

        state, _ = tloop.train_loop(cfg, data, state=tloop.TrainState(
            merged, tadamw.adamw_init(merged)), **kw)
        return C.instance_views(state.params, 0).tree()

    def worst(a, b):
        out = []
        _walk(lambda path, x, y: out.append(float((x - y).abs().max())), a, b)
        return max(out)

    inst0 = fused((50, 51, 52))
    assert worst(inst0, fused((50, 61, 62))) < 1e-5
    solo0 = C.training_params(cfg1, singles()[0].tree())
    solo, _ = tloop.train_loop(cfg1, tpipe.SyntheticLM(64, 1, seed=50), state=tloop.TrainState(
        solo0, tadamw.adamw_init(solo0)), **kw)
    assert worst(inst0, solo.params.tree()) < 1e-3


def test_launch_train_saves_a_checkpoint_the_reference_reads(tmp_path):
    """``launch/train.py --device cpu --smoke --steps 3 --save``: the
    JAX package's ``checkpoint.restore`` reads what it wrote, and JAX's
    forward on it equals the port's within 1e-5."""
    state, losses = tlaunch.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
                                  "--steps", "3", "--batch", "2", "--seq", "16",
                                  "--save", str(tmp_path / "ck")])
    assert len(losses) == 2 and all(np.isfinite(l) for _, l in losses)
    jcfg = jreg.get_smoke_config("tinyllama-1.1b")
    like = jax.eval_shape(lambda: japi.init(jcfg, jax.random.PRNGKey(0)))
    jp = jckpt.restore(tmp_path / "ck", like)
    toks = jpipe.SyntheticLM(jcfg.vocab_size, 1, seed=17).batch(0, 2, 16)["tokens"]
    want = japi.train_logits(jcfg, jp, {"tokens": toks})
    tcfg = treg.get_smoke_config("tinyllama-1.1b")
    with torch.no_grad():
        got = tapi.train_logits(tcfg, state.params,
                                {"tokens": torch.from_numpy(np.array(toks))})
    _close("logits", got, want)


def test_unported_families_and_the_mesh_flag_raise():
    """Every family has its whole-sequence entries now; the launcher's
    ``--mesh`` (data-parallel training) still raises."""
    assert sorted(tapi.WHOLE_SEQUENCE) == sorted(tapi._FAMILY)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlaunch.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--mesh"])
