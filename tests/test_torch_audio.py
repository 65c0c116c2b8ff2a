"""The port's audio family (``repro_torch.models.audio``, whisper-small)
against ``repro.models.audio`` on the CPU, whisper-smoke in f32.

Both packages get the same weights (``repro.api.init`` on JAX's CPU,
carried across with ``checkpoint.bridge.params_from_numpy``) and the same
numpy-seeded inputs.  The encoder's states, the carry of a chunked
prefill (self-attention ring and cross-attention K/V, lanes reading other
instances' weights too) and a decode step's logits must lie within 1e-4
of the reference's (f32: only summation order differs); the engine's
greedy streams at K = 1 and 8 must equal the exact-length reference
stream of ``tests/test_serving_chunked.py``'s whisper-small case (zero
frames, as both engines serve them); a slot copy moves all F rows of the
cross cache.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import registry as jreg
from repro.models import audio as jaudio
from repro.models import common as JC
from repro_torch import api as tapi
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch.models import audio as taudio
from repro_torch.models.common import merge_drawn
from repro_torch.serving import MultiModelServer, Request

ARCH = "whisper-small"
TOL = dict(rtol=1e-4, atol=1e-4)
M = 2


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_P = {}


def _both():
    if not _P:
        jcfg = jreg.get_smoke_config(ARCH).with_(num_instances=M)
        tcfg = treg.get_smoke_config(ARCH).with_(num_instances=M)
        jp = japi.init(jcfg, jax.random.PRNGKey(0))
        _P["v"] = (jcfg, tcfg, jp, params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu"))
    return _P["v"]


def _frames(cfg, m, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (m, b, cfg.num_audio_frames, cfg.d_model)).astype(np.float32)


def _gathered(jp, idx):
    """The reference's tree with instance rows ``idx`` (per lane)."""
    return {k: ({n: v[:, idx] for n, v in sub.items()} if isinstance(sub, dict) else sub[idx])
            for k, sub in jp.items()}


def test_bridge_keeps_every_leaf():
    """The bridge's tree has the reference's groups, names and shapes, each
    leaf equal to the reference's array (f32 smoke: no cast)."""
    _, _, jp, tp = _both()
    tree = tp.tree()
    assert set(tree) == set(jp)
    for group, sub in jp.items():
        pairs = sub.items() if isinstance(sub, dict) else [(None, sub)]
        for name, leaf in pairs:
            got = tree[group] if name is None else tree[group][name]
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf), err_msg=f"{group}.{name}")


def test_encode_matches_reference():
    jcfg, tcfg, jp, tp = _both()
    fr = _frames(jcfg, M, 2, 1)
    want = jaudio.encode(jcfg, jp, jnp.asarray(fr))
    got = taudio.encode(tcfg, tp, torch.from_numpy(fr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("lanes", [None, [1, 0, 1]], ids=["own", "lane_groups"])
def test_prefill_chunk_then_decode_match_reference(lanes):
    """Chunks of 5 over a 12-token prompt with random frames (the last
    chunk padded, ``valid`` False past the prompt): the self ring and the
    cross K/V within 1e-4 of the reference's; then a decode step's logits
    and greedy tokens.  ``lane_groups``: three lanes reading instances 1,
    0, 1 through ``instances=``, against the reference on those rows."""
    jcfg, tcfg, jp, tp = _both()
    n_tok, c, ctx = 12, 5, 32
    m = M if lanes is None else len(lanes)
    rng = np.random.default_rng(2)
    fr = _frames(jcfg, m, 1, 3)
    toks = rng.integers(1, jcfg.vocab_size, (m, 1, 15)).astype(np.int32)
    jref = jp if lanes is None else _gathered(jp, np.array(lanes))
    jcfg_l = jcfg.with_(num_instances=m)
    jcarry = japi.init_chunk_carry(jcfg_l, m, 1, ctx)
    jprefill = jax.jit(japi.prefill_chunk, static_argnums=0)
    tcarry = tapi.init_chunk_carry(tcfg.with_(num_instances=m), m, 1, ctx, device="cpu")
    for start in range(0, 15, c):
        valid = np.broadcast_to(start + np.arange(c) < n_tok, (m, 1, c)).copy()
        chunk = toks[..., start:start + c]
        off = np.full((m, 1), start, np.int32)
        jcarry = jprefill(jcfg_l, jref, {"tokens": jnp.asarray(chunk), "frames": jnp.asarray(fr),
                                         "valid": jnp.asarray(valid)}, jcarry, jnp.asarray(off))
        tapi.prefill_chunk(tcfg, tp, {"tokens": torch.from_numpy(chunk),
                                      "frames": torch.from_numpy(fr),
                                      "valid": torch.from_numpy(valid)},
                           tcarry, torch.from_numpy(off), instances=lanes)
    tc, jc = tcarry["cache"], jcarry["cache"]
    for got, want in ((tc["self"].k, jc["self"].k), (tc["self"].v, jc["self"].v),
                      (tc["cross_k"], jc["cross_k"]), (tc["cross_v"], jc["cross_v"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not tc["self"].k[:, :, :, n_tok:].any()
    assert tc["cross_k"].abs().amin(dim=(0, 1, 2, 4, 5)).gt(0).all()      # every frame written
    if lanes is not None:
        return
    tok = toks[:, :, n_tok:n_tok + 1]
    pos = np.full((m, 1), n_tok, np.int32)
    jlog, _ = japi.decode_step(jcfg, jp, jc, jnp.asarray(tok), jnp.asarray(pos))
    clone = {"self": type(tc["self"])(tc["self"].k.clone(), tc["self"].v.clone()),
             "cross_k": tc["cross_k"], "cross_v": tc["cross_v"]}
    tlog, _ = tapi.decode_step(tcfg, tp, clone, torch.from_numpy(tok), torch.from_numpy(pos))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    nxt, _ = tapi.decode_step_sample(tcfg, tp, tc, torch.from_numpy(tok), torch.from_numpy(pos))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnp.argmax(jlog, axis=-1)))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cross_attention_matches_plain_attention(dt):
    """The prefill's cross-attention (two merged matmuls per lane and kv
    head, the softmax sum as a column of ones) against the one-block
    plain attention with every frame visible.  f32 within TOL; bf16
    within 2e-2, where the sum adds p rounded to V's dtype and the plain
    version adds p unrounded."""
    from repro_torch.models import layers as L

    rng = np.random.default_rng(12)
    m, b, c, h, kvh, hd, fr = 3, 2, 5, 4, 2, 16, 23
    tdt = getattr(torch, dt)
    q = torch.from_numpy(rng.standard_normal((m, b, c, h, hd)).astype(np.float32)).to(tdt)
    k, v = (torch.from_numpy(rng.standard_normal((m, b, fr, kvh, hd)).astype(np.float32))
            .to(tdt) for _ in range(2))
    zero = lambda n: torch.zeros((m, b, n), dtype=torch.int32)
    want = L.flash_attention_plain(q, k, v, zero(c), zero(fr))
    got = taudio._cross_attention(q, k, v)
    assert got.dtype == tdt and got.shape == (m, b, c, h, hd)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **(TOL if dt == "float32" else dict(rtol=2e-2, atol=2e-2)))


def test_prefill_keeps_cross_rows_of_lanes_with_no_real_row():
    """A lane whose chunk rows are all junk (``valid`` False) keeps its
    cross K/V and its ring: the in-place form of the reference engine's
    lane select (the lane finished earlier in the same advance)."""
    _, tcfg, _, tp = _both()
    fr = torch.from_numpy(_frames(tcfg, M, 1, 4))
    carry = tapi.init_chunk_carry(tcfg, M, 1, 16, device="cpu")
    tok = torch.ones((M, 1, 4), dtype=torch.int32)
    tapi.prefill_chunk(tcfg, tp, {"tokens": tok, "frames": fr}, carry,
                       torch.zeros((M, 1), dtype=torch.int32))
    before = {k: carry["cache"][k].clone() for k in ("cross_k", "cross_v")}
    ring = carry["cache"]["self"].k.clone()
    valid = torch.zeros((M, 1, 4), dtype=torch.bool)
    valid[0] = True
    tapi.prefill_chunk(tcfg, tp, {"tokens": tok, "frames": 2 * fr, "valid": valid}, carry,
                       torch.full((M, 1), 4, dtype=torch.int32))
    for k, old in before.items():
        assert torch.equal(carry["cache"][k][:, 1], old[:, 1])
        assert not torch.equal(carry["cache"][k][:, 0], old[:, 0])
    assert torch.equal(carry["cache"]["self"].k[:, 1], ring[:, 1])


def test_slot_copy_keeps_every_cross_frame():
    """``api.take_state`` / ``put_state`` move a slot's cross K/V whole (F
    rows, labelled ``cache_seq``: the grid's F equals the carry's), and
    prefix-clip the self ring where the contexts differ."""
    _, tcfg, _, _ = _both()
    g = torch.Generator().manual_seed(5)
    one = tapi.make_cache(tcfg, 1, 1, 24, device="cpu")
    for leaf in (one["self"].k, one["self"].v, one["cross_k"], one["cross_v"]):
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    grid = tapi.make_cache(tcfg, M, 2, 16, device="cpu")
    tapi.put_state(tcfg, grid, tapi.take_state(tcfg, one, 0, 0), 1, 1)
    f = tcfg.num_audio_frames
    for k in ("cross_k", "cross_v"):
        assert grid[k].shape[3] == f and torch.equal(grid[k][:, 1, 1], one[k][:, 0, 0])
        assert not grid[k][:, 0].any() and not grid[k][:, 1, 0].any()
    assert torch.equal(grid["self"].k[:, 1, 1], one["self"].k[:, 0, 0, :16])
    back = tapi.make_cache(tcfg, 1, 1, 16, device="cpu")
    tapi.put_state(tcfg, back, tapi.take_state(tcfg, grid, 1, 1), 0, 0)
    assert torch.equal(back["cross_v"], one["cross_v"])


_jprefill = jax.jit(japi.prefill, static_argnums=0, static_argnames="cache_len")
_jdecode = jax.jit(japi.decode_step, static_argnums=0)


def _reference_stream(cfg, pi, prompt, max_new, max_context):
    """``tests/test_serving_chunked.py``'s reference: exact-length prefill
    of ``prompt[:-1]`` on the instance's isolated weights, then greedy
    ``decode_step`` from the last prompt token."""
    batch = {"tokens": jnp.asarray(prompt[:-1], jnp.int32)[None, None],
             "frames": jnp.zeros((1, 1, cfg.num_audio_frames, cfg.d_model),
                                 jnp.dtype(cfg.dtype))}
    _, cache = _jprefill(cfg, pi, batch, cache_len=max_context)
    tok, pos, out = prompt[-1], len(prompt) - 1, []
    for _ in range(max_new):
        logits, cache = _jdecode(cfg, pi, cache, jnp.full((1, 1, 1), tok, jnp.int32),
                                 jnp.full((1, 1), pos, jnp.int32))
        tok = int(jnp.argmax(logits[0, 0]))
        out.append(tok)
        pos += 1
    return out


_STREAMS = {}


@pytest.mark.parametrize("k", [1, 8])
def test_engine_streams_match_exact_length_reference(k):
    """The whisper-small case of ``test_serving_chunked``'s ``FAMILY_CASES``
    (smoke config, M = 2, 2 slots, context 64, chunk 5 over 3 lanes,
    budget 2, prompts of 2, 3, 7, 12 and 18 tokens, 4 new) at K = 1 and 8:
    every greedy stream equals the exact-length reference's, so K = 1 ==
    K = 8."""
    jcfg, tcfg, jp, tp = _both()
    rng = np.random.default_rng(0)
    reqs = [Request(i % 2, rng.integers(1, jcfg.vocab_size, size=n).tolist(), 4)
            for i, n in enumerate((2, 3, 7, 12, 18))]
    if not _STREAMS:
        ax = japi.axes(jcfg)
        for i, r in enumerate(reqs):
            _STREAMS[i] = _reference_stream(jcfg, JC.take_instance(jp, ax, r.instance),
                                            r.prompt, 4, 64)
    srv = MultiModelServer(tcfg, tp, device="cpu", slots_per_instance=2, max_context=64,
                           prefill_chunk=5, prefill_lanes=3, chunk_budget=2, decode_steps=k)
    ids = [srv.submit(r) for r in reqs]
    got = {r.request_id: r.tokens for r in srv.run_until_drained()}
    assert [got[i] for i in ids] == [_STREAMS[i] for i in range(len(reqs))]


def test_init_draws_in_place_and_storage_dtypes():
    """``random_merged`` draws the merged model in place, equal bit for bit
    to one-instance draws merged; matmul leaves (the biases too) in the
    activation dtype, embed, pos_embed and the norms in param_dtype; the
    tree's shapes are the reference's."""
    over = dict(num_layers=1, encoder_layers=1, num_instances=2, d_model=64, d_ff=96,
                num_heads=4, num_kv_heads=4, vocab_size=101, num_audio_frames=8,
                max_target_positions=40)
    cfg = treg.get_config(ARCH).with_(**over)
    cpu = torch.device("cpu")
    whole = serve.random_merged(cfg, 5, cpu)[0]
    one = cfg.with_(num_instances=1)
    merged = merge_drawn(lambda j: taudio.init(one, torch.Generator().manual_seed(5000 + j),
                                               cpu), 2)
    want = jax.eval_shape(lambda: japi.init(jreg.get_config(ARCH).with_(**over),
                                            jax.random.PRNGKey(0)))
    tree, ref = whole.tree(), merged.tree()
    for group, sub in want.items():
        pairs = sub.items() if isinstance(sub, dict) else [(None, sub)]
        for name, leaf in pairs:
            got = tree[group] if name is None else tree[group][name]
            exp = ref[group] if name is None else ref[group][name]
            assert tuple(got.shape) == leaf.shape and torch.equal(got, exp), (group, name)
    lay = tree["dec_layers"]
    assert lay["x_wq"].dtype == lay["b1"].dtype == torch.bfloat16
    assert lay["ln_x_s"].dtype == tree["pos_embed"].dtype == tree["embed"].dtype == torch.float32
    assert lay["w1"].float().std().item() == pytest.approx(64 ** -0.5, rel=0.1)


def test_serve_cli_smoke(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "4",
                "--max-new", "3", "--decode-steps", "4"])
    assert "served 4 requests" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="audio"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh-shape", "1x2"])
