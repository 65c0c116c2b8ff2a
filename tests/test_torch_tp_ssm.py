"""Tensor-parallel xLSTM (ssm family) serving in the port, on the CPU,
against the JAX package.

``shard_params`` is held to the rules of ``shardings.xlstm_split``: which
columns, rows and heads each leaf keeps, and that a part that does not
divide stays whole on every rank.  One mLSTM and one sLSTM block run on
ranks in lockstep threads (``_Lockstep``: the sums and gathers of the
``TensorParallel`` handle, in process) against the reference's
``ssm.mlstm_block`` / ``ssm.slstm_block`` on the whole model, a prefill
chunk with a junk tail and a decode step: every rank's output and the
rank state shards put back together, f32 at 1e-5 (the row-split sums
add in another order).  The engine runs in real rank processes
(``mesh.spawn``, gloo), one spawn per mesh shape, and its greedy streams
are held against the JAX package's single-device engine, as
``tests/test_torch_tp_hybrid.py`` holds hybrid: the reference's own ssm
mesh test fails on this JAX.  xlstm-smoke (2 heads, vocab 256 so that
the head splits) and its 4-head widening (d_model 128: the sLSTM head
dim stays 32, the card kernel's step; vocab 257 stays whole), M=2, f32.
"""
import threading
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import registry as jreg
from repro.models import ssm as jssm
from repro.serving import MultiModelServer as JServer
from repro.serving import Request as JRequest
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.launch import mesh, serve
from repro_torch.models import shardings
from repro_torch.models import ssm as tssm
from repro_torch.serving import Request

TOL = dict(rtol=1e-5, atol=1e-5)
M = 2
ARCH = "xlstm-1.3b"


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# name -> overrides of xlstm-smoke (3 layers: mLSTM, sLSTM, mLSTM)
CONFIGS = {
    "smoke": dict(vocab_size=256),
    "wide4": dict(d_model=128, num_heads=4, num_kv_heads=4),
}
_PARAMS = {}


def _params(name):
    if name not in _PARAMS:
        kw = dict(CONFIGS[name], num_instances=M)
        jcfg = jreg.get_smoke_config(ARCH).with_(**kw)
        tcfg = treg.get_smoke_config(ARCH).with_(**kw)
        jp = jax.jit(lambda key: japi.init(jcfg, key))(jax.random.PRNGKey(0))
        _PARAMS[name] = (jcfg, tcfg, jp,
                         params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu"))
    return _PARAMS[name]


def _np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# shard_params: the three splits of the xLSTM family
# ---------------------------------------------------------------------------


def _heads_of(t, dim, rank, n):
    return t.chunk(n, dim)[rank]


@pytest.mark.parametrize("name,n", [("smoke", 2), ("wide4", 2), ("wide4", 4)])
def test_shard_params_xlstm_slices(name, n):
    """Each rank holds its heads' ``xi`` columns then its heads' ``z``
    columns of ``w_up`` (two blocks), its channels of the conv, the out
    norm and the rows of ``w_gates`` and ``w_down``, its heads of q, k, v
    and r, for each of the four gates its heads' columns of ``w_in`` and
    ``b_in``, its slice of the sLSTM FFN and (V 256) of ``lm_head``; it
    shares ``b_gates``, the norms, the embedding and an odd vocab's head
    with the whole model; its state shard follows its heads."""
    _, tcfg, _, tp = _params(name)
    di, d, ff = tssm.d_inner(tcfg), tcfg.d_model, tssm.slstm_ff(tcfg)
    split = shardings.xlstm_split(tcfg, SimpleNamespace(rank=0, size=n))
    assert split.heads is not None and split.ffn is not None
    vocab = shardings.vocab_split(tcfg, n)
    assert vocab == (tcfg.vocab_size % n == 0)
    whole = tp.tree()
    for r in range(n):
        s = shardings.shard_params(tcfg, tp, r, n).tree()
        run, w_run = s["mlstm_runs"][0], whole["mlstm_runs"][0]
        xi, z = w_run["w_up"].split(di, dim=3)
        want_up = torch.cat([_heads_of(xi, 3, r, n), _heads_of(z, 3, r, n)], 3)
        assert run["w_up"].is_contiguous() and torch.equal(run["w_up"], want_up)
        for k, dim in (("conv_w", 3), ("conv_b", 2), ("out_norm", 2), ("wq", 2), ("wk", 2),
                       ("wv", 2), ("w_gates", 2), ("w_down", 2)):
            assert torch.equal(run[k], _heads_of(w_run[k], dim, r, n)), k
        for k in ("b_gates", "norm"):
            assert run[k].data_ptr() == w_run[k].data_ptr(), k
        lay, w_lay = s["slstm"][0], whole["slstm"][0]
        for k in ("w_in", "b_in"):
            gates = w_lay[k].chunk(4, -1)
            want = torch.cat([_heads_of(g, -1, r, n) for g in gates], -1)
            assert lay[k].shape[-1] == 4 * d // n and torch.equal(lay[k], want), k
        for k, dim in (("r", 2), ("out_norm", 1), ("w_ff_gate", 2), ("w_ff_up", 2),
                       ("w_ff_down", 1)):
            assert torch.equal(lay[k], _heads_of(w_lay[k], dim, r, n)), k
        assert lay["w_ff_gate"].shape[2] == ff // n
        for k in ("norm", "ffn_norm"):
            assert lay[k].data_ptr() == w_lay[k].data_ptr(), k
        for k in ("embed", "final_norm"):
            assert s[k].data_ptr() == whole[k].data_ptr(), k
        if vocab:
            assert torch.equal(s["lm_head"], _heads_of(whole["lm_head"], 2, r, n))
        else:
            assert s["lm_head"].data_ptr() == whole["lm_head"].data_ptr()
        st = tssm.make_state(tcfg, M, 1, "cpu", tp=SimpleNamespace(rank=r, size=n))
        h_l = tcfg.num_heads // n
        assert st["mlstm_runs"][0]["C"].shape[3] == h_l
        assert st["mlstm_runs"][0]["conv"].shape[-1] == di // n
        assert all(v.shape[-1] == d // n for v in st["slstm"][0].values())


def test_shard_params_keeps_undivided_parts_whole():
    """At T=3 neither the 4 heads, nor the FFN of 128, nor V=257 divide:
    every leaf of every rank is the whole model's, and so is its state."""
    _, tcfg, _, tp = _params("wide4")
    assert shardings.xlstm_split(tcfg, SimpleNamespace(rank=0, size=3)) == (None, None)
    assert not shardings.vocab_split(tcfg, 3)
    whole = tp.tree()
    flat = lambda t: [x for x in jax.tree.leaves(t) if x is not None]
    for r in range(3):
        s = shardings.shard_params(tcfg, tp, r, 3).tree()
        assert [a.data_ptr() for a in flat(s)] == [a.data_ptr() for a in flat(whole)]
    st = tssm.make_state(tcfg, M, 1, "cpu", tp=SimpleNamespace(rank=2, size=3))
    one = tssm.make_state(tcfg, M, 1, "cpu")
    assert [a.shape for a in flat(st)] == [a.shape for a in flat(one)]


# ---------------------------------------------------------------------------
# one block on ranks in lockstep threads against the reference's blocks
# ---------------------------------------------------------------------------


class _Lockstep:
    """n ranks as threads of one process, each with a stand-in for its
    ``TensorParallel`` handle: ``all_reduce_sum`` is the f32 sum of the
    ranks' partials in rank order, rounded once (as in
    ``tests/test_torch_tp_hybrid.py``), ``all_gather`` the ranks' tensors
    concatenated in rank order."""

    def __init__(self, n):
        self.n = n
        self.parts = [None] * n
        self.barrier = threading.Barrier(n, timeout=120)   # a rank that fails breaks it

    def _exchange(self, rank, t, combine):
        self.parts[rank] = t
        self.barrier.wait()
        out = combine(list(self.parts))
        self.barrier.wait()
        return out

    def all_reduce_sum(self, rank, part):
        total = self._exchange(rank, part.to(torch.float32),
                               lambda ps: sum(ps[1:], ps[0].clone()))
        return total.to(part.dtype)

    def all_gather(self, rank, t, dim=-1):
        return self._exchange(rank, t, lambda ps: torch.cat(ps, dim))

    def run(self, fn):
        """``fn(handle)`` on every rank; the results in rank order."""
        def rank(r):
            return fn(SimpleNamespace(
                rank=r, size=self.n, all_reduce_sum=lambda t: self.all_reduce_sum(r, t),
                all_gather=lambda t, dim=-1: self.all_gather(r, t, dim)))
        with ThreadPoolExecutor(self.n) as ex:
            return list(ex.map(rank, range(self.n)))


def _block_inputs(cfg, s, seed):
    """x (M, 1, s, D), the valid mask (lane 0 ends after 4 steps of a
    prefill chunk, lane 1 is junk throughout; None for a decode step) and
    a carried state of both blocks' layouts (mLSTM C, n, m, conv; sLSTM
    c, n, h, m)."""
    rng = np.random.default_rng(seed)
    d, di, h = cfg.d_model, tssm.d_inner(cfg), cfg.num_heads
    hd = di // h
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x = f32(M, 1, s, d)
    valid = (np.arange(s)[None, None] < np.array([4, 0])[:, None, None]) if s > 1 else None
    mst = {"C": 0.3 * f32(M, 1, h, hd, hd), "n": np.abs(f32(M, 1, h, hd)) + 1,
           "m": f32(M, 1, h), "conv": 0.5 * f32(M, 1, cfg.conv_kernel - 1, di)}
    sst = {"c": f32(M, 1, d), "n": np.abs(f32(M, 1, d)) + 1, "h": 0.3 * f32(M, 1, d),
           "m": f32(M, 1, d)}
    return x, valid, mst, sst


# per leaf of a block's state: the dim its rank shard cuts
MLSTM_STATE_DIM = {"C": 2, "n": 2, "m": 2, "conv": 3}
SLSTM_STATE_DIM = {"c": 2, "n": 2, "h": 2, "m": 2}


@pytest.mark.parametrize("s", [6, 1], ids=["prefill", "decode"])
@pytest.mark.parametrize("block", ["mlstm", "slstm"])
@pytest.mark.parametrize("name,n", [("smoke", 2), ("wide4", 4)])
def test_block_on_ranks_matches_reference_block(name, n, block, s):
    """Each rank runs the port's block on its shard (the mLSTM's gate and
    down-projection sums, the sLSTM's gather and FFN sum through the
    lockstep handles); every rank's output equals the reference's block
    on the whole model, and the ranks' state shards put back together in
    rank order equal the reference's new state.  A prefill chunk of 6
    steps (lane 0 valid for 4, lane 1 junk throughout) and a decode
    step."""
    jcfg, tcfg, jp, tp = _params(name)
    x, valid, mst, sst = _block_inputs(tcfg, s, seed=7 + s)
    st, dims = (mst, MLSTM_STATE_DIM) if block == "mlstm" else (sst, SLSTM_STATE_DIM)
    jv = None if valid is None else jnp.asarray(valid)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    if block == "mlstm":
        jlp = jax.tree.map(lambda t: t[0], jp["mlstm_runs"][0])
        ref = jax.jit(lambda lp, x, st, v: jssm.mlstm_block(jcfg, lp, x, state=st,
                                                             chunk=jcfg.mlstm_chunk, valid=v))
    else:
        jlp = jp["slstm"][0]
        ref = jax.jit(lambda lp, x, st, v: jssm.slstm_block(jcfg, lp, x, state=st, valid=v))
    want, wst = ref(jlp, jnp.asarray(x), jst, jv)

    def rank(h):
        shard = shardings.shard_params(tcfg, tp, h.rank, n)
        split = shardings.xlstm_split(tcfg, h)
        assert split.heads is h and split.ffn is h
        mine = {k: torch.from_numpy(v).chunk(n, dims[k])[h.rank].clone() for k, v in st.items()}
        xt = torch.from_numpy(x)
        tv = None if valid is None else torch.from_numpy(valid)
        if block == "mlstm":
            lp = {k: v[0] for k, v in shard["mlstm_runs"][0].tree().items()}
            out = tssm.mlstm_block(tcfg, lp, xt, mine, chunk=tcfg.mlstm_chunk, valid=tv,
                                   heads=split.heads)
        else:
            out = tssm.slstm_block(tcfg, shard["slstm"][0].tree(), xt, mine, valid=tv,
                                   split=split)
        return out, mine

    outs = _Lockstep(n).run(rank)
    for r, (got, _) in enumerate(outs):
        np.testing.assert_allclose(got.numpy(), _np(want), err_msg=f"rank {r}", **TOL)
    for k, dim in dims.items():
        whole = torch.cat([mine[k] for _, mine in outs], dim)
        np.testing.assert_allclose(whole.float().numpy(), _np(wst[k]), err_msg=k, **TOL)


# ---------------------------------------------------------------------------
# the engine in gloo ranks against the JAX single-device engine
# ---------------------------------------------------------------------------

SERVER_KW = dict(slots_per_instance=2, max_context=64, prefill_chunk=8, prefill_lanes=3,
                 chunk_budget=3)
# (D, T) -> the runs of one spawn, (config, K)
MESH_RUNS = {(1, 2): [("smoke", 1), ("smoke", 8)], (2, 2): [("smoke", 8)],
             (1, 4): [("wide4", 8)]}
_RUNS = {}


def _requests(req_cls, vocab):
    """Prompts of 1 to 45 tokens over several chunks and mixed budgets, so
    lanes finish at different calls and slots stop mid-block at K=8."""
    rng = np.random.default_rng(3)
    return [req_cls(i % M, rng.integers(1, vocab, n).tolist(), 2 + i % 6)
            for i, n in enumerate((19, 1, 33, 6, 45, 12))]


def _jax_streams(name, k):
    if ("jax", name, k) not in _RUNS:
        jcfg, _, jp, _ = _params(name)
        srv = JServer(jcfg, jp, decode_steps=k, temperature=0.0, **SERVER_KW)
        for r in _requests(JRequest, jcfg.vocab_size):
            srv.submit(r)
        _RUNS["jax", name, k] = {r.request_id: r.tokens for r in srv.run_until_drained()}
    return _RUNS["jax", name, k]


def _mesh_runs(d, t):
    """Per rank: {(config, K): serve_rank's result}."""
    if (d, t) not in _RUNS:
        runs = MESH_RUNS[d, t]
        calls = [(serve.serve_rank, _params(n)[1], _params(n)[3],
                  _requests(Request, _params(n)[1].vocab_size),
                  dict(SERVER_KW, decode_steps=k)) for n, k in runs]
        ranks = mesh.spawn(mesh.in_turn, t, *calls, device="cpu", data=d)
        _RUNS[d, t] = [dict(zip(runs, r)) for r in ranks]
    return _RUNS[d, t]


ENGINE_CASES = [(d, t, n, k) for (d, t), runs in sorted(MESH_RUNS.items()) for n, k in runs]


@pytest.mark.parametrize("d,t,name,k", ENGINE_CASES,
                         ids=[f"{d}x{t}-{n}-K{k}" for d, t, n, k in ENGINE_CASES])
def test_engine_streams_match_jax_single_device(d, t, name, k):
    """Every rank's greedy streams equal the JAX single-device engine's;
    each rank made the same device calls; per layer pass (a decode step
    or a chunk call) the model group summed twice an mLSTM layer and once
    an sLSTM layer and gathered once an sLSTM layer; the greedy decode's
    vocab combine is two small all-reduces a step where the head splits
    (the CPU tensors ran the plain versions: no launch counted)."""
    want = _jax_streams(name, k)
    assert want and all(want.values())
    _, tcfg, _, _ = _params(name)
    n_slstm = len(tssm.mlstm_runs(tcfg)) - 1
    n_mlstm = tcfg.num_layers - n_slstm
    runs = [r[name, k] for r in _mesh_runs(d, t)]
    for r in runs:
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["streams"] == want
        assert (r["decode_blocks"], r["prefill_calls"]) == (runs[0]["decode_blocks"],
                                                            runs[0]["prefill_calls"])
        assert r["snapshot"]["mesh"] == {"shape": {"data": d, "model": t}, "devices": d * t}
        assert r["launches"]["slstm_cell"] == r["launches"]["logits_sample"] == 0
        steps, calls = r["snapshot"]["decode_steps"], r["prefill_calls"]
        passes = steps + calls
        c = r["collectives"]
        assert c["all_reduce_sum"] == (2 * n_mlstm + n_slstm) * passes, (c, passes)
        assert c["all_gather"] == n_slstm * passes, (c, passes)
        vocab = shardings.vocab_split(tcfg, t)
        assert c.get("all_reduce", 0) == (2 * steps if vocab else 0), (c, steps)


def test_serve_cli_xlstm_mesh_1x2_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh-shape", "1x2",
                "--requests", "6", "--decode-steps", "4"])
    out = capsys.readouterr().out
    assert "backend gloo" in out and "streams identical" in out
