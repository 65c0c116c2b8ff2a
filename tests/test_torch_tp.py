"""Tensor-parallel dense serving in the port, on the CPU, against the JAX
package.

The phases of the sharded decode layer run in process against the
reference's Pallas kernels in interpret mode (``_layer_call`` phase
"attn", ``_ffn_call``) on each rank's weight slices, and their partials
summed over the ranks against ``ref.decode_layer``: f32, rtol/atol 1e-5
(summation order only).  The model and the engine run in real rank
processes (``mesh.spawn``, gloo) and are held against the JAX package's
single-device XLA path, as the reference's own mesh tests hold its mesh
path (tests/test_megakernel.py): caches and logits within 1e-4 (f32;
the cross-rank sum adds the partials in another order than one matmul
does), greedy tokens exact.  The smoke configs use a vocab of 256 here,
so that it splits over 2 and 4 ranks.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import registry as jreg
from repro.kernels.decode_layer import _ffn_call, _layer_call
from repro.kernels.decode_layer import tp_head_plan as ref_tp_head_plan
from repro.kernels import ref
from repro.serving import MultiModelServer as JServer
from repro.serving import Request as JRequest
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.kernels import decode_layer as dl
from repro_torch.kernels import ops
from repro_torch.launch import mesh, serve, tp_parity
from repro_torch.models import shardings
from repro_torch.serving import Request

TOL = dict(rtol=1e-4, atol=1e-4)
PHASE_TOL = dict(rtol=1e-5, atol=1e-5)
M, VOCAB = 2, 256


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_PARAMS = {}


def _params(arch="tinyllama-1.1b"):
    if arch not in _PARAMS:
        jcfg = jreg.get_smoke_config(arch).with_(num_instances=M, vocab_size=VOCAB)
        tcfg = treg.get_smoke_config(arch).with_(num_instances=M, vocab_size=VOCAB)
        jp = japi.init(jcfg, jax.random.PRNGKey(0))
        _PARAMS[arch] = (jcfg, tcfg, jp,
                         params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu"))
    return _PARAMS[arch]


def _np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# rules and slices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_tp_head_plan_matches_reference(n):
    for h in (1, 4, 8, 12, 16, 25, 32):
        for kvh in (1, 2, 4, 5, 8, 16):
            if h % kvh == 0:
                assert dl.tp_head_plan(h, kvh, n) == ref_tp_head_plan(h, kvh, n), (h, kvh, n)


@pytest.mark.parametrize("arch,n", [("tinyllama-1.1b", 2), ("tinyllama-1.1b", 4),
                                    ("qwen1.5-0.5b", 2), ("qwen1.5-0.5b", 4)])
def test_shard_params_slices_and_rules(arch, n):
    """Each rank holds a contiguous 1/n of every split leaf; the ranks'
    slices concatenate to the whole; a layer whose kv heads do not divide
    stays whole (the data-local branch); lm_head splits by vocab."""
    _, tcfg, _, tp = _params(arch)
    split = shardings.layers_split(tcfg, n)
    assert split == (tcfg.num_kv_heads % n == 0)
    shards = [shardings.shard_params(tcfg, tp, r, n) for r in range(n)]
    for k, dim in shardings.LAYER_SPLIT_DIM.items():
        if k not in tp["layers"]:
            continue
        full = tp["layers"][k]
        parts = [s["layers"][k] for s in shards]
        if split:
            assert all(p.is_contiguous() and p.shape[dim] == full.shape[dim] // n for p in parts)
            assert torch.equal(torch.cat(parts, dim), full)
        else:
            assert all(p.data_ptr() == full.data_ptr() for p in parts)
    assert torch.equal(torch.cat([s["lm_head"] for s in shards], 2), tp["lm_head"])
    for s in shards:
        for leaf in (s["embed"], s["layers"]["attn_norm"]):      # replicated: shared, not copied
            assert leaf.data_ptr() in (tp["embed"].data_ptr(),
                                       tp["layers"]["attn_norm"].data_ptr())
    assert shardings.local_kv_heads(tcfg, n) == (tcfg.num_kv_heads // n if split
                                                 else tcfg.num_kv_heads)


# ---------------------------------------------------------------------------
# the two phases, in process, against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _layer_np(rng, m, b, d, h, kvh, hd, ff, s, bias):
    r = lambda *shp, sc=0.1: (rng.standard_normal(shp) * sc).astype(np.float32)
    lp = {"attn_norm": 1 + r(m, d), "wq": r(m, d, h * hd), "wk": r(m, d, kvh * hd),
          "wv": r(m, d, kvh * hd), "wo": r(m, h * hd, d), "mlp_norm": 1 + r(m, d),
          "w_gate": r(m, d, ff), "w_up": r(m, d, ff), "w_down": r(m, ff, d)}
    if bias:
        lp.update(bq=r(m, h * hd), bk=r(m, kvh * hd), bv=r(m, kvh * hd))
    x = r(m, b, d, sc=1.0)
    ck, cv = r(m, b, s, kvh, hd, sc=1.0), r(m, b, s, kvh, hd, sc=1.0)
    pos = rng.integers(0, 2 * s, (m, b)).astype(np.int32)
    return lp, x, ck, cv, pos


def _rank_slices(lp, ck, cv, rank, n):
    """A rank's weight and cache slices of one layer (no L axis)."""
    t = lambda a: torch.from_numpy(a)
    lpl = {k: (shardings.shard(t(v), shardings.LAYER_SPLIT_DIM[k] - 1, rank, n)
               if k in shardings.LAYER_SPLIT_DIM else t(v)) for k, v in lp.items()}
    return (lpl, shardings.shard(t(ck), 3, rank, n), shardings.shard(t(cv), 3, rank, n))


PHASE_CASES = {  # arch -> (h, kvh, bias, window): the smoke configs' heads, per rank at T=2
    "tinyllama-1.1b": (4, 2, False, 0),
    "qwen1.5-0.5b": (4, 4, True, 6),
}


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("arch", sorted(PHASE_CASES))
def test_phases_match_pallas_interpret(arch, rank):
    """Rank ``rank``'s attention and FFN phases (T=2, M=2, B=2) against
    ``_layer_call(phase="attn")`` and ``_ffn_call`` in interpret mode on
    the same slices: the partials and the appended ring shard."""
    h, kvh, bias, window = PHASE_CASES[arch]
    d, hd, ff, s, n = 64, 16, 96, 16, 2
    lp, x, ck, cv, pos = _layer_np(np.random.default_rng(rank), M, 2, d, h, kvh, hd, ff, s,
                                   bias)
    lpl, ckl, cvl = _rank_slices(lp, ck, cv, rank, n)
    kw = dict(head_dim=hd, rope_theta=10000.0, window=window, eps=1e-5)
    jlp = {k: jnp.asarray(v.numpy()) for k, v in lpl.items()}
    layer_call = jax.jit(functools.partial(_layer_call, num_heads=h // n, interpret=True,
                                           phase="attn", **kw))
    want, wk, wv = layer_call(jlp, jnp.asarray(x), jnp.asarray(ckl.numpy()),
                              jnp.asarray(cvl.numpy()), jnp.asarray(pos))
    got, gk, gv = ops.decode_layer_attn(lpl, torch.from_numpy(x), ckl.clone(), cvl.clone(),
                                        torch.from_numpy(pos), num_heads=h // n, **kw)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.numpy(), _np(w), **PHASE_TOL)
    x2 = np.asarray(want) + x
    want = _ffn_call(jnp.asarray(x2), *(jnp.asarray(lpl[k].numpy()) for k in
                                          ("mlp_norm", "w_gate", "w_up", "w_down")),
                         eps=1e-5, interpret=True)
    got = ops.decode_layer_ffn(torch.from_numpy(x2), lpl["mlp_norm"], lpl["w_gate"],
                               lpl["w_up"], lpl["w_down"], eps=1e-5)
    np.testing.assert_allclose(got.numpy(), _np(want), **PHASE_TOL)


@pytest.mark.parametrize("arch", sorted(PHASE_CASES))
def test_rank_partials_sum_to_reference_layer(arch):
    """The ranks' partials, summed as ``TensorParallel.all_reduce_sum``
    sums them, plus the residual equal ``ref.decode_layer``; the ranks'
    ring shards concatenate to its cache."""
    h, kvh, bias, window = PHASE_CASES[arch]
    d, hd, ff, s, n = 64, 16, 96, 16, 2
    lp, x, ck, cv, pos = _layer_np(np.random.default_rng(7), M, 2, d, h, kvh, hd, ff, s, bias)
    kw = dict(head_dim=hd, rope_theta=10000.0, window=window, eps=1e-5)
    want = jax.jit(functools.partial(ref.decode_layer, num_heads=h, **kw))(
        {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(x), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(pos))
    ranks = [_rank_slices(lp, ck, cv, r, n) for r in range(n)]
    xt, post = torch.from_numpy(x), torch.from_numpy(pos)
    parts = [dl.decode_layer_attn_plain(lpl, xt, ckl, cvl, post, num_heads=h // n, **kw)
             for lpl, ckl, cvl in ranks]
    x2 = xt + sum(p[0] for p in parts)
    out = x2 + sum(dl.ffn_plain(x2, lpl["mlp_norm"], lpl["w_gate"], lpl["w_up"],
                                lpl["w_down"]) for lpl, _, _ in ranks)
    np.testing.assert_allclose(out.numpy(), _np(want[0]), **PHASE_TOL)
    for i, w in ((1, want[1]), (2, want[2])):
        np.testing.assert_allclose(torch.cat([p[i] for p in parts], 3).numpy(), _np(w),
                                   **PHASE_TOL)


# ---------------------------------------------------------------------------
# the model in two gloo ranks
# ---------------------------------------------------------------------------

_RUNS = {}
N_POS, WIDTH, CTX = 24, 8, 48


def _tp2_chunk_decode():
    if "chunk_decode" not in _RUNS:
        jcfg, tcfg, jp, tp = _params()
        tok = np.random.default_rng(3).integers(1, VOCAB, (M, 2, N_POS)).astype(np.int32)
        jcarry = japi.init_chunk_carry(jcfg, M, 2, CTX)
        for start in range(0, N_POS, WIDTH):
            off = jnp.full((M, 2), start, jnp.int32)
            jcarry = japi.prefill_chunk(jcfg, jp, {"tokens": jnp.asarray(
                tok[:, :, start:start + WIDTH])}, jcarry, off)
        pos = jnp.full((M, 2), N_POS, jnp.int32)
        logits, _ = japi.decode_step(jcfg, jp, jcarry["cache"], jnp.asarray(tok[:, :, -1:]), pos)
        ranks = mesh.spawn(tp_parity.chunk_decode_rank, 2, tcfg, tp, torch.from_numpy(tok),
                           WIDTH, CTX, device="cpu")
        _RUNS["chunk_decode"] = (jcarry["cache"], np.asarray(logits), ranks)
    return _RUNS["chunk_decode"]


def test_tp2_prefill_cache_shards_match_jax():
    """Two ranks' prefill chunks: each holds one of the two kv heads; the
    shards concatenated over kv heads equal the single-device cache."""
    jcache, _, ranks = _tp2_chunk_decode()
    for leaf, w in (("k", jcache.k), ("v", jcache.v)):
        assert all(r[leaf].shape[4] == 1 for r in ranks)
        np.testing.assert_allclose(torch.cat([r[leaf] for r in ranks], 4).numpy(), _np(w),
                                   **TOL)


def test_tp2_decode_logits_match_jax():
    _, logits, ranks = _tp2_chunk_decode()
    for r in ranks:
        assert r["logits"].shape == (M, 2, VOCAB)
        np.testing.assert_allclose(r["logits"].numpy(), logits, **TOL)


def test_tp2_greedy_tokens_match_jax():
    _, logits, ranks = _tp2_chunk_decode()
    for r in ranks:
        np.testing.assert_array_equal(r["tokens"].numpy(), logits.argmax(-1))


def test_tp2_tied_embeddings_split_by_vocab_rows():
    """A tied head splits by the embedding's V rows (the lookup table stays
    whole): gathered logits and greedy tokens equal the JAX ones."""
    jcfg = jreg.get_smoke_config("tinyllama-1.1b").with_(num_instances=M, vocab_size=VOCAB,
                                                         tie_embeddings=True)
    tcfg = treg.get_smoke_config("tinyllama-1.1b").with_(num_instances=M, vocab_size=VOCAB,
                                                         tie_embeddings=True)
    jp = japi.init(jcfg, jax.random.PRNGKey(1))
    assert "lm_head" not in jp
    tok = np.random.default_rng(4).integers(1, VOCAB, (M, 2, 12)).astype(np.int32)
    jcarry = japi.prefill_chunk(jcfg, jp, {"tokens": jnp.asarray(tok)},
                                japi.init_chunk_carry(jcfg, M, 2, 32), jnp.zeros((M, 2), jnp.int32))
    logits, _ = japi.decode_step(jcfg, jp, jcarry["cache"], jnp.asarray(tok[:, :, -1:]),
                                 jnp.full((M, 2), 12, jnp.int32))
    ranks = mesh.spawn(tp_parity.chunk_decode_rank, 2, tcfg,
                       params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu"),
                       torch.from_numpy(tok), 12, 32, device="cpu")
    for r in ranks:
        np.testing.assert_allclose(r["logits"].numpy(), _np(logits), **TOL)
        np.testing.assert_array_equal(r["tokens"].numpy(), np.asarray(logits).argmax(-1))


def test_logits_sample_sharded_first_occurrence():
    """The max sits in both ranks' vocab slices (duplicated head
    columns): rank 0's lower index wins; where only rank 1 holds it, its
    global index comes back."""
    rng = np.random.default_rng(5)
    d, v = 32, VOCAB
    x = torch.from_numpy(rng.standard_normal((M, 2, d)).astype(np.float32))
    scale = torch.ones(M, d)
    head = torch.from_numpy(rng.standard_normal((M, d, v)).astype(np.float32)) * 0.1
    xn = x / x.pow(2).mean(-1, keepdim=True).add(1e-5).sqrt()
    win = xn.sum(1) / (2 * d ** 0.5) * 10                   # a clear winner for every lane
    tied = head.clone()
    tied[:, :, 5] = win
    tied[:, :, v // 2 + 3] = win
    upper = head.clone()
    upper[:, :, v // 2 + 7] = win
    out = mesh.spawn(mesh.in_turn, 2, (tp_parity.logits_rank, x, scale, tied),
                     (tp_parity.logits_rank, x, scale, upper), device="cpu")
    for rank_out in out:
        assert (rank_out[0] == 5).all(), rank_out[0]
        assert (rank_out[1] == v // 2 + 7).all(), rank_out[1]
    assert torch.equal(out[0][0], ops.logits_sample(x, scale, tied))


# ---------------------------------------------------------------------------
# the engine in 2 and 4 gloo ranks against the JAX single-device engine
# ---------------------------------------------------------------------------


def _requests(req_cls):
    rng = np.random.default_rng(0)
    return [req_cls(i % M, rng.integers(1, VOCAB, int(rng.integers(2, 30))).tolist(),
                    int(rng.integers(2, 9))) for i in range(6)]


SERVER_KW = dict(slots_per_instance=2, max_context=64, prefill_chunk=8)


def _jax_streams(k):
    if ("jax", k) not in _RUNS:
        jcfg, _, jp, _ = _params()
        srv = JServer(jcfg, jp, decode_steps=k, **SERVER_KW)
        for r in _requests(JRequest):
            srv.submit(r)
        _RUNS["jax", k] = {r.request_id: r.tokens for r in srv.run_until_drained()}
    return _RUNS["jax", k]


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("n", [2, 4])
def test_engine_streams_match_jax_single_device(n, k):
    """T=2 splits heads, FFN and vocab; T=4 keeps the layers whole on
    every rank (2 kv heads do not split over 4) and splits the vocab.
    Every rank's greedy streams equal the JAX engine's."""
    _, tcfg, _, tp = _params()
    want = _jax_streams(k)
    assert want and all(want.values())
    ranks = mesh.spawn(serve.serve_rank, n, tcfg, tp, _requests(Request),
                       dict(SERVER_KW, decode_steps=k), device="cpu")
    for r in ranks:
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["streams"] == want


def test_sampled_streams_identical_across_ranks():
    """Temperature sampling draws from the gathered logits with the same
    seeded generator on every rank: the ranks agree token for token."""
    _, tcfg, _, tp = _params()
    ranks = mesh.spawn(serve.serve_rank, 2, tcfg, tp, _requests(Request),
                       dict(SERVER_KW, decode_steps=4, temperature=0.8, top_k=20, seed=3),
                       device="cpu")
    assert ranks[0]["streams"] == ranks[1]["streams"]
    assert all(0 <= t < VOCAB for s in ranks[0]["streams"].values() for t in s)


def test_serve_cli_mesh_1x2_on_cpu():
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                        "tinyllama-1.1b", "--smoke", "--device", "cpu", "--mesh-shape", "1x2",
                        "--requests", "6", "--decode-steps", "4"],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH="src"),
                       cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "backend gloo" in r.stdout and "streams identical" in r.stdout


def test_serve_cli_mesh_2x2_on_cpu():
    """The data axis: 4 gloo ranks, each data group serving 2 of the 4
    instances under tensor parallelism over 2; every rank's streams
    identical."""
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                        "tinyllama-1.1b", "--smoke", "--device", "cpu", "--mesh-shape", "2x2",
                        "--requests", "6", "--decode-steps", "4"],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH="src"),
                       cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "mesh 2x2 (data x model)" in r.stdout and "data split instances" in r.stdout
    assert "4 ranks on" in r.stdout and "streams identical" in r.stdout
