"""Training and the whole-sequence prefill of the moe, vlm and audio
families against the JAX package on the CPU, and the merged-matmul
kernel's autograd Function.

Both packages get the same weights: ``repro.api.init`` on JAX's CPU,
carried across with ``checkpoint.bridge.params_from_numpy`` and made
trainable (``common.training_params``).  f32 smoke configs at M = 2,
B = 2; the batches are drawn with numpy from a seed (vlm adds patch
embeddings, audio frames); one jitted JAX ``value_and_grad`` per family.
Tolerances, as ``tests/test_torch_train.py`` states them:

* ``train_logits``, ``loss_fn`` (loss, nll, moe's aux), ``prefill``'s
  last logits and every cache leaf: 1e-5 (f32 on both sides with the same
  rounding points; summation order is what is left);
* every gradient leaf within 1e-4 of that leaf's largest magnitude;
* ``remat=True`` against ``remat=False``: bit for bit.

olmoe-smoke routes 16 tokens a row to 2 of 4 experts at a capacity of
ceil(16 * 2 / 4 * 1.25) = 10 rows an expert, so assignments are dropped
and the keep rule is held under a gradient.  On the CPU the merged matmul
runs its plain version under ``fused_matmul.Merged``, so the moe
gradients hold the Function's backward against ``jax.grad``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as japi
from repro.configs import registry as jreg
from repro_torch import api as tapi
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.kernels import fused_matmul as fm
from repro_torch.launch import train as tlaunch
from repro_torch.models import common as C
from repro_torch.models import moe as tmoe
from repro_torch.train import loop as tloop
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedules as tsched

TOL = dict(rtol=1e-5, atol=1e-5)
M, B, S = 2, 2, 16
ARCHS = ("olmoe-1b-7b", "internvl2-26b", "whisper-small")


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
    tree of the same structure (dicts, lists, NamedTuples)."""
    if isinstance(got, dict):
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


def _batch(cfg, seed, s=S):
    """numpy arrays of one batch: tokens and labels (M, B, s) and the
    family's stub inputs (vlm patch embeddings, audio frames)."""
    g = np.random.default_rng(seed)
    toks = g.integers(0, cfg.vocab_size, (M, B, s + 1)).astype(np.int32)
    out = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.family == "vlm":
        out["image_embeds"] = g.standard_normal(
            (M, B, cfg.num_image_patches, cfg.vision_embed_dim), np.float32) * 0.5
    if cfg.family == "audio":
        out["frames"] = g.standard_normal(
            (M, B, cfg.num_audio_frames, cfg.d_model), np.float32) * 0.5
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def _torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


_FAM = {}


def _family(arch):
    """(jcfg, tcfg, JAX params, numpy tree, numpy batch, JAX (loss,
    metrics, logits), JAX grads): one jitted value_and_grad."""
    if arch not in _FAM:
        # the reference without remat: the same numbers, a shorter compile
        jcfg = jreg.get_smoke_config(arch).with_(num_instances=M, remat=False)
        tcfg = treg.get_smoke_config(arch).with_(num_instances=M)
        jp = japi.init(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jp)
        nb = _batch(jcfg, 1)
        jb = {k: jnp.asarray(v) for k, v in nb.items()}

        def loss(p):
            l, met = japi.loss_fn(jcfg, p, jb)
            return l, (met, japi.train_logits(jcfg, p, jb))

        (jl, (jm, jlog)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
        _FAM[arch] = (jcfg, tcfg, jp, tree, nb, (jl, jm, jlog), jg)
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
    jcfg, tcfg, jp, tree, nb, (jl, jm, jlog), jg = _family(arch)
    tb = _torch(nb)
    p, loss, met = _port_grads(tcfg, tree, tb)
    with torch.no_grad():
        out = tapi.train_logits(tcfg, p, tb)
    if tcfg.family == "moe":
        logits, aux = out
        jlog, jaux = jlog
        _close("train_logits aux", aux, jaux)
        assert float(met["aux"].detach()) > 0
    else:
        logits = out
    assert logits.shape == (M, B, S, tcfg.vocab_size) and logits.dtype == torch.float32
    _close("logits", logits, jlog)
    _close("loss", loss, jl)
    _close("nll", met["nll"], jm["nll"])
    _close("aux", met["aux"], jm["aux"])
    missing = [n for n, q in p.named_parameters() if q.grad is None]
    assert not missing, missing
    _walk(_grad_close, p.tree("grad"), jax.tree.map(np.asarray, jg), "grad")


def test_moe_smoke_drops_assignments_at_its_capacity():
    """The moe gradients above are taken where routing drops: at
    olmoe-smoke's capacity some (row, expert) pair of the first layer
    gets more assignments than it keeps."""
    jcfg, tcfg, _, tree, nb, _, _ = _family("olmoe-1b-7b")
    cap = tmoe.capacity(tcfg, S)
    assert cap == 10 and cap < S
    p = params_from_numpy(tcfg, tree, "cpu")
    with torch.no_grad():
        x = tmoe.dense._embed_in(tcfg, p, torch.from_numpy(nb["tokens"]))
        r = tmoe.route(tcfg, p["layers"]["router"][0], x, cap=cap)
    assert int(r["keep"].sum()) < M * B * S * tcfg.num_experts_per_tok


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_loss_and_grads_bit_for_bit(arch):
    _, tcfg, _, tree, nb, _, _ = _family(arch)
    p1, l1, m1 = _port_grads(tcfg, tree, _torch(nb), remat=True)
    p0, l0, m0 = _port_grads(tcfg, tree, _torch(nb), remat=False)
    assert torch.equal(l1, l0) and torch.equal(m1["aux"], m0["aux"])
    _walk(lambda path, a, b: torch.equal(a, b) or pytest.fail(path),
          p1.tree("grad"), p0.tree("grad"))


def _chunked_cache(cfg, params, batch, cache_len, chunk=5):
    """The serving path's prefill of the whole prompt (every position,
    vlm's patch positions first), ``chunk`` positions a call: the carry's
    cache.  moe routes at the whole prompt's capacity (``moe_limit``), as
    the whole prefill does."""
    tok = batch["tokens"]
    m, b, n = tok.shape
    pre = tapi.prefill_prefix_len(cfg)
    ctx = torch.cat([torch.zeros(m, b, pre, dtype=tok.dtype), tok], dim=2) if pre else tok
    carry = tapi.init_chunk_carry(cfg, m, b, cache_len, device="cpu")
    extra = {k: batch[k] for k in ("image_embeds", "frames") if k in batch}
    if cfg.family == "moe":
        extra["moe_limit"] = torch.full((m, b), tmoe.capacity(cfg, n), dtype=torch.int32)
    for start in range(0, ctx.shape[2], chunk):
        off = torch.full((m, b), start, dtype=torch.int32)
        tapi.prefill_chunk(cfg, params, {"tokens": ctx[:, :, start:start + chunk], **extra},
                           carry, off)
    return carry["cache"]


def _greedy(cfg, params, tok, cache, pos0, steps=4):
    """``steps`` greedy decode steps from the token ``tok`` (M, B): the
    tokens (steps, M, B) and each step's logits."""
    toks, outs = [], []
    for k in range(steps):
        logits, cache = tapi.decode_step(cfg, params, cache, tok[..., None],
                                         torch.full_like(tok, pos0 + k))
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok)
        outs.append(logits)
    return torch.stack(toks), outs


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference_and_the_chunked_path(arch):
    """``api.prefill`` against the reference's ``prefill`` at the same
    ``cache_len``: last logits and every cache leaf within 1e-5.  Then the
    serving path's chunked prefill of the same prompt gives the same cache
    within 1e-5, and 4 greedy decode steps from either cache, starting at
    the whole prefill's token, give the same tokens, which are the
    reference's decode steps' tokens."""
    jcfg, tcfg, jp, tree, nb, _, _ = _family(arch)
    tp = params_from_numpy(tcfg, tree, "cpu")
    tb = _torch(nb)
    pre = tapi.prefill_prefix_len(tcfg)
    cache_len = pre + S + 4
    jb = {k: jnp.asarray(v) for k, v in nb.items() if k != "labels"}
    jlog, jcache = jax.jit(lambda p, b: japi.prefill(jcfg, p, b, cache_len=cache_len))(jp, jb)
    tlog, tcache = tapi.prefill(tcfg, tp, tb, cache_len=cache_len)
    _close("logits", tlog, jlog)
    _walk(_close, tcache, jcache, "cache")

    with torch.no_grad():
        ccache = _chunked_cache(tcfg, tp, tb, cache_len)
        _walk(_close, ccache, tcache, "chunked cache")
        tok = tlog.argmax(-1).to(torch.int32)
        w_tok, _ = _greedy(tcfg, tp, tok, tcache, pre + S)
        c_tok, _ = _greedy(tcfg, tp, tok, ccache, pre + S)
    assert torch.equal(w_tok, c_tok)
    jdec = jax.jit(lambda c, t, pos: japi.decode_step(jcfg, jp, c, t, pos))
    jtok = jnp.asarray(tok.numpy())
    for k in range(4):
        jl_, jcache = jdec(jcache, jtok[..., None], jnp.full((M, B), pre + S + k, jnp.int32))
        jtok = jnp.argmax(jl_, -1).astype(jnp.int32)
        np.testing.assert_array_equal(w_tok[k].numpy(), np.asarray(jtok), err_msg=f"step {k}")


def _matmul_case(seed, xdt, wdt, bias, m=3, t=5, d=8, f=6):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, t, d, generator=g).to(xdt)
    w = (torch.randn(m, d, f, generator=g) / d ** 0.5).to(wdt)
    b = torch.randn(m, f, generator=g) if bias else None
    dy = torch.randn(m, t, f, generator=g).to(xdt)
    return x, w, b, dy


@pytest.mark.parametrize("xdt,wdt,bias", [
    (torch.float32, torch.float32, False), (torch.float32, torch.float32, True),
    (torch.bfloat16, torch.float32, False), (torch.bfloat16, torch.float32, True)],
    ids=["f32", "f32-bias", "bf16-x-f32-w", "bf16-x-f32-w-bias"])
def test_fused_matmul_function_grads_match_bmm_autograd(xdt, wdt, bias):
    """``fused_matmul.Merged`` with the plain version as its forward: dx,
    dw and db against autograd through ``torch.bmm`` of the plain math (w
    cast to x's dtype, f32 sums, the bias in f32).  dx comes back in x's
    dtype, dw in w's, db in b's.  f32: summation order only (1e-6); with
    x in bf16 the two round the same f32 sums to bf16 (1 ulp, 2^-8, of
    the largest magnitude)."""
    x, w, b, dy = _matmul_case(3, xdt, wdt, bias)
    ins = [t.clone().requires_grad_() for t in (x, w) + ((b,) if bias else ())]
    y = fm.fused_matmul_grad(fm.fused_matmul_plain, *ins)
    assert y.dtype == xdt and y.grad_fn is not None
    got = torch.autograd.grad(y, ins, dy)

    ref = [t.clone().requires_grad_() for t in (x, w) + ((b,) if bias else ())]
    want_y = torch.bmm(ref[0].float(), ref[1].to(xdt).float())
    if bias:
        want_y = want_y + ref[2].float()[:, None, :]
    want = torch.autograd.grad(want_y.to(xdt), ref, dy)
    tol = 1e-6 if xdt == torch.float32 else 2 ** -8
    for name, g_, w_, src in zip(("dx", "dw", "db"), got, want, ins):
        assert g_.dtype == src.dtype, name
        err = (g_.float() - w_.float()).abs().max() / w_.float().abs().max()
        assert err <= tol, (name, float(err))


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_matmul_function_hands_the_kernel_contiguous_operands(xdt):
    """The backward hands its callable what the kernel takes: contiguous
    operands of x's dtype (the transposed ones copied), also where w
    already has x's dtype; and only the operands that need a gradient get
    one (x alone: dx and no dw).  The forward passes w as it is given (the
    kernel casts it)."""
    x, w, _, dy = _matmul_case(5, xdt, torch.float32, False)
    calls = []

    def fwd(*a):
        ops_ = [t for t in a if t is not None]
        assert all(t.is_contiguous() for t in ops_) and ops_[0].dtype == xdt
        if calls:
            assert ops_[1].dtype == xdt
        calls.append(tuple(t.shape for t in ops_))
        return fm.fused_matmul_plain(*a)

    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = fm.fused_matmul_grad(fwd, xg, w.to(xdt))
    (dx,) = torch.autograd.grad(y, [xg], dy)
    assert calls == [((3, 5, 8), (3, 8, 6)), ((3, 5, 6), (3, 6, 8))]
    want = fm.fused_matmul_plain(dy, w.to(xdt).transpose(1, 2).contiguous())
    assert torch.equal(dx, want)
    calls.clear()
    y = fm.fused_matmul_grad(fwd, xg, wg)
    torch.autograd.grad(y, [xg, wg], dy)
    assert calls == [((3, 5, 8), (3, 8, 6)), ((3, 5, 6), (3, 6, 8)), ((3, 8, 5), (3, 5, 6))]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_init_draws_the_serving_weights_in_param_dtype(arch):
    """``api.init(..., train=True)`` draws the serving init's numbers (the
    f32 smoke stores every leaf in f32 either way), every leaf a
    parameter that requires a gradient."""
    cfg = treg.get_smoke_config(arch).with_(num_instances=M)
    serve = tapi.init(cfg, torch.Generator().manual_seed(4), "cpu")
    train = tapi.init(cfg, torch.Generator().manual_seed(4), "cpu", train=True)
    assert train.trainable and all(p.requires_grad and p.dtype == torch.float32
                                   for p in train.parameters())
    _walk(lambda path, a, b: torch.equal(a, b) or pytest.fail(path), train.tree(), serve.tree())


def test_microbatches_slice_the_image_embeds():
    """Two microbatches of B/2 give one batch of B's loss: the slicing
    along B covers vlm's patch embeddings as it does the tokens."""
    _, tcfg, _, tree, nb, _, _ = _family("internvl2-26b")
    losses = []
    for mb in (1, 2):
        p = _trainable(tcfg, tree)
        _, met = tloop.make_train_step(tcfg, lr_schedule=tsched.constant(1e-3),
                                       microbatches=mb)(
            tloop.TrainState(p, tadamw.adamw_init(p)), _torch(nb))
        losses.append(float(met["loss"]))
    np.testing.assert_allclose(losses[1], losses[0], **TOL)


def test_launch_train_trains_the_moe_smoke_on_the_cpu(capsys):
    """``launch/train.py --arch olmoe-1b-7b --smoke --device cpu``: finite
    losses and the router's aux in the log."""
    _, losses = tlaunch.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                              "--num-instances", "2", "--steps", "3", "--batch", "2",
                              "--seq", "16"])
    assert len(losses) == 2 and all(np.isfinite(l) for _, l in losses)
    assert " aux " in capsys.readouterr().out
