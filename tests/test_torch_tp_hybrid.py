"""Tensor-parallel hybrid (hymba) serving in the port, on the CPU, against
the JAX package.

``decode_attention_sharded`` runs each rank's block in process; the
ranks' outputs, concatenated over the heads, are held against
``ref.decode_attention`` on the whole heads, against the reference's
repeat form, and against the reference's own ``decode_attention_sharded``
on a forced CPU mesh (a subprocess, the way the reference's mesh tests
run it): f32, rtol/atol 1e-5 (summation order only).  One hybrid block
runs on ranks in lockstep threads (``_Lockstep``: the sums of
``TensorParallel.all_reduce_sum``, in process) against the reference's
``hymba_block`` at 1e-5.  The engine runs in real rank processes
(``mesh.spawn``, gloo) and its greedy streams are held against the JAX
package's single-device engine, as ``tests/test_torch_tp.py`` holds the
dense family: the reference's own hybrid mesh test fails on this JAX.
hymba-smoke at 4 layers (global {0, 2, 3}, SWA {1}), M=2, f32.
"""
import os
import subprocess
import sys
import textwrap
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import registry as jreg
from repro.kernels import ref
from repro.models import hybrid as jhyb
from repro.serving import MultiModelServer as JServer
from repro.serving import Request as JRequest
from repro_torch import api as tapi
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import ops
from repro_torch.kernels.decode_layer import tp_head_plan
from repro_torch.launch import mesh, serve
from repro_torch.models import hybrid as thyb
from repro_torch.models import layers as L
from repro_torch.models import shardings
from repro_torch.serving import MultiModelServer, Request

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
M = 2
R = thyb.NUM_META_TOKENS


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# name -> overrides of hymba-smoke (4 layers): "kv" at T=2, "expand" at
# T=4, and 5 q heads over 1 kv head (hymba-1.5b's geometry at T=2: the
# attention stays whole, the FFN and the mamba branch split)
CONFIGS = {
    "smoke": {},
    "heads5x1": dict(num_heads=5, num_kv_heads=1, head_dim=32),
}
_PARAMS = {}


def _params(name="smoke"):
    if name not in _PARAMS:
        kw = dict(CONFIGS[name], num_instances=M, num_layers=4)
        jcfg = jreg.get_smoke_config("hymba-1.5b").with_(**kw)
        tcfg = treg.get_smoke_config("hymba-1.5b").with_(**kw)
        jp = japi.init(jcfg, jax.random.PRNGKey(0))
        _PARAMS[name] = (jcfg, tcfg, jp,
                         params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu"))
    return _PARAMS[name]


def _np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# decode_attention_sharded: every plan, each rank's block in process
# ---------------------------------------------------------------------------

# name -> (h, kvh, T); the plan each reaches
ATTN_CASES = {
    "none_5x1_T2": (5, 1, 2),          # None: hymba-1.5b's geometry at T=2
    "kv_4x2_T2": (4, 2, 2),            # "kv": hymba-smoke at T=2
    "kv_25x5_T5": (25, 5, 5),          # "kv": hymba-1.5b at T=5
    "expand_4x2_T4": (4, 2, 4),        # "expand", one kv head per rank
    "expand_6x2_T3": (6, 2, 3),        # "expand", rank 1 reads 2 kv heads evenly
    "straddle_12x3_T2": (12, 3, 2),    # "expand", uneven: 4 + 2 q heads per rank
}
PLANS = {"none_5x1_T2": None, "kv_4x2_T2": "kv", "kv_25x5_T5": "kv",
         "expand_4x2_T4": "expand", "expand_6x2_T3": "expand",
         "straddle_12x3_T2": "expand"}
HD, S_CACHE = 16, 24


def _attn_inputs(case):
    h, kvh, _ = ATTN_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.standard_normal((M, 2, h, HD)).astype(np.float32)
    k, v = (rng.standard_normal((M, 2, S_CACHE, kvh, HD)).astype(np.float32) for _ in range(2))
    kv_len = np.array([[1, S_CACHE], [7, 13]], np.int32)
    return q, k, v, kv_len


def _rank_blocks(q, k, v, kv_len, n):
    """Every rank's output of ``decode_attention_sharded`` on its block:
    its q heads and the kv heads of its cache shard."""
    h, kvh = q.shape[2], k.shape[3]
    plan = tp_head_plan(h, kvh, n)
    outs = []
    for rank in range(n):
        tp = SimpleNamespace(rank=rank, size=n)
        lo, hi, _ = (da.rank_kv_heads(h, kvh, n, rank) if plan else (0, kvh, None))
        ql = q.chunk(n, 2)[rank] if plan else q
        outs.append(ops.decode_attention_sharded(
            ql.contiguous(), k[:, :, :, lo:hi].contiguous(), v[:, :, :, lo:hi].contiguous(),
            kv_len, plan=plan, tp=tp, num_kv_heads=kvh))
    return plan, outs


def _whole(plan, outs):
    return torch.cat(outs, 2) if plan else outs[0]


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_rank_kv_heads_and_plans(case):
    """The plan each case reaches; the ranks' kv ranges cover the kv heads
    in order, and ``index`` is None exactly where the q heads group
    evenly over them."""
    h, kvh, n = ATTN_CASES[case]
    assert tp_head_plan(h, kvh, n) == PLANS[case]
    ranges = [da.rank_kv_heads(h, kvh, n, r) for r in range(n)]
    assert ranges[0][0] == 0 and ranges[-1][1] == kvh
    assert all(b[0] in (a[1] - 1, a[1]) for a, b in zip(ranges, ranges[1:]))
    uneven = [r for r, (_, _, index) in enumerate(ranges) if index is not None]
    assert uneven == ([0, 1] if case.startswith("straddle") else [])
    if case.startswith("straddle"):
        assert ranges == [(0, 2, [0, 0, 0, 0, 1, 1]), (1, 3, [0, 0, 1, 1, 1, 1])]


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_decode_attention_sharded_matches_reference(case):
    """The ranks' outputs concatenated over the heads equal
    ``ref.decode_attention`` on the whole heads; under "expand" they also
    equal the plain version on the reference's repeat form (KV repeated
    to one head per q head, then split).  On CPU tensors the plain
    version runs and no launch is counted."""
    q, k, v, kv_len = _attn_inputs(case)
    h, kvh, n = ATTN_CASES[case]
    want = ref.decode_attention(*(jnp.asarray(x) for x in (q, k, v, kv_len)))
    ops.reset_launches()
    plan, outs = _rank_blocks(*(torch.from_numpy(x) for x in (q, k, v, kv_len)), n)
    assert ops.launches()["decode_attention_sharded"] == 0
    assert all(o.shape == (M, 2, h // n if plan else h, HD) for o in outs)
    np.testing.assert_allclose(_whole(plan, outs).numpy(), _np(want), **TOL)
    if plan == "expand":
        g = h // kvh
        kr, vr = (torch.from_numpy(np.repeat(x, g, axis=3)) for x in (k, v))
        rep = torch.cat([da.decode_attention_plain(qr, kk, vv, torch.from_numpy(kv_len))
                         for qr, kk, vv in zip(torch.from_numpy(q).chunk(n, 2),
                                               kr.chunk(n, 3), vr.chunk(n, 3))], 2)
        np.testing.assert_allclose(_whole(plan, outs).numpy(), rep.numpy(), **TOL)


def test_decode_attention_sharded_one_device_is_the_plain_call():
    q, k, v, kv_len = (torch.from_numpy(x) for x in _attn_inputs("kv_4x2_T2"))
    got = ops.decode_attention_sharded(q, k, v, kv_len, plan=None, tp=None, num_kv_heads=2)
    assert torch.equal(got, ops.decode_attention(q, k, v, kv_len))
    with pytest.raises(ValueError, match="kv heads"):
        ops.decode_attention_sharded(q[:, :, :1], k, v, kv_len, plan="expand",
                                     tp=SimpleNamespace(rank=0, size=4), num_kv_heads=2)


_REF_SHARDED = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.kernels.decode_attn import decode_attention_sharded
from repro.launch.shardings import serve_rules

data = dict(np.load(sys.argv[1]))
out = {}
for key in sorted({k.split("/")[0] for k in data}):
    n = int(data[key + "/n"])
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(1, n), ("data", "model"))
    rules = serve_rules(mesh)
    args = [jnp.asarray(data[key + "/" + a]) for a in ("q", "k", "v", "kv_len")]
    with jax.set_mesh(mesh), rules:
        out[key] = np.asarray(decode_attention_sharded(*args, rules=rules))
np.savez(sys.argv[2], **out)
"""


def test_decode_attention_sharded_matches_reference_shard_map(tmp_path):
    """The reference's ``decode_attention_sharded`` (Pallas in interpret
    mode under ``shard_map`` on a forced CPU mesh of 1 x T) and the port's
    per-rank blocks agree for every case that fits 4 host devices."""
    cases = [c for c, (_, _, n) in ATTN_CASES.items() if n <= 4]
    arrays = {}
    for c in cases:
        for name, x in zip(("q", "k", "v", "kv_len"), _attn_inputs(c)):
            arrays[f"{c}/{name}"] = x
        arrays[f"{c}/n"] = np.array(ATTN_CASES[c][2])
    np.savez(tmp_path / "in.npz", **arrays)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF_SHARDED),
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                       capture_output=True, text=True, timeout=300, cwd=str(REPO),
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")
    for c in cases:
        plan, outs = _rank_blocks(*(torch.from_numpy(x) for x in _attn_inputs(c)),
                                  ATTN_CASES[c][2])
        np.testing.assert_allclose(_whole(plan, outs).numpy(), want[c], err_msg=c, **TOL)


# ---------------------------------------------------------------------------
# shard_params: the three splits of the hybrid family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_shard_params_hybrid_slices(n):
    """hymba-smoke: 4 q heads over 2 kv heads ("kv" at T=2, "expand" at
    T=4: each rank reads the one kv head of its q head), d_ff 256 and 4
    SSM heads of 64 channels split.  Each rank holds its contiguous 1/n
    of the q-head, FFN and SSM-head leaves, the kv heads it reads, the
    whole xi half of ``w_ssm_in`` before its z slice, and shares every
    other leaf with the whole model; its cache follows the plan."""
    _, tcfg, _, tp = _params()
    lay = tp["layers"]
    hd, di = tcfg.head_dim, thyb.d_inner(tcfg)
    assert shardings.head_plan(tcfg, n) == ("kv" if n == 2 else "expand")
    assert shardings.ffn_split(tcfg, n) and shardings.ssm_split(tcfg, n)
    shards = [shardings.shard_params(tcfg, tp, r, n)["layers"] for r in range(n)]
    for k, dim in (("wq", 3), ("wo", 2), ("w_gate", 3), ("w_up", 3), ("w_down", 2),
                   ("d_skip", 2), ("w_ssm_out", 2)):
        parts = [s[k] for s in shards]
        assert all(p.is_contiguous() and p.shape[dim] == lay[k].shape[dim] // n
                   for p in parts), k
        assert torch.equal(torch.cat(parts, dim), lay[k]), k
    z = torch.cat([s["w_ssm_in"][..., di:] for s in shards], 3)
    assert torch.equal(z, lay["w_ssm_in"][..., di:])
    for r, s in enumerate(shards):
        assert torch.equal(s["w_ssm_in"][..., :di], lay["w_ssm_in"][..., :di])
        kv = r * 2 // n                      # the one kv head of the rank's q heads
        assert shardings.local_kv_heads(tcfg, n, r) == 1
        for k in ("wk", "wv"):
            assert torch.equal(s[k], lay[k][..., kv * hd:(kv + 1) * hd]), (k, r)
        for k in ("norm", "conv_w", "w_bc", "w_dt", "b_dt", "a_log", "mlp_norm"):
            assert s[k].data_ptr() == lay[k].data_ptr(), k
        h = SimpleNamespace(rank=r, size=n)
        cache = thyb.make_cache(tcfg, M, 1, 192, "cpu", tp=h)
        assert all(kv_.k.shape[4] == 1 for kv_ in cache["kv"])
        assert cache["ssm"]["h"].shape[3] == di // n and cache["ssm"]["conv"].shape[4] == di


def test_shard_params_keeps_undivided_parts_whole():
    """hymba-1.5b's geometry at T=2 (5 q heads over 1 kv head): the
    attention stays whole on every rank while the FFN and the mamba branch
    split; at T=3 nothing divides and the shard is the whole model."""
    _, tcfg, _, tp = _params("heads5x1")
    assert shardings.head_plan(tcfg, 2) is None
    s = shardings.shard_params(tcfg, tp, 1, 2)["layers"]
    for k in ("wq", "wk", "wv", "wo"):
        assert s[k].data_ptr() == tp["layers"][k].data_ptr(), k
    assert s["w_gate"].shape[3] == tcfg.d_ff // 2 and s["d_skip"].shape[2] == 128
    assert shardings.local_kv_heads(tcfg, 2) == 1
    whole = shardings.shard_params(tcfg, tp, 2, 3)["layers"]
    assert all(whole[k].data_ptr() == tp["layers"][k].data_ptr() for k in tp["layers"].keys())


def test_tp_rejects_the_audio_family():
    """The audio family has no model axis: ``shard_params``, the api's
    ``tp`` keyword and the engine (given a model group of 2 ranks, before
    it touches the params) raise, naming the queue item; a data-only
    handle (a model group of 1) is served."""
    cfg = treg.get_smoke_config("whisper-small")
    two = SimpleNamespace(rank=0, size=2, data=None)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        shardings.shard_params(cfg, None, 0, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        tapi.make_cache(cfg, 1, 1, 8, device="cpu", tp=two)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        MultiModelServer(cfg, None, slots_per_instance=1, max_context=8, device="cpu", tp=two)


# ---------------------------------------------------------------------------
# one block on ranks in lockstep threads against the reference's hymba_block
# ---------------------------------------------------------------------------


class _Lockstep:
    """n ranks as threads of one process, each with a stand-in for its
    ``TensorParallel`` handle whose ``all_reduce_sum`` is the f32 sum of
    the ranks' partials in rank order, rounded once."""

    def __init__(self, n):
        self.n = n
        self.parts = [None] * n
        self.barrier = threading.Barrier(n, timeout=120)   # a rank that fails breaks it

    def all_reduce_sum(self, rank, part):
        self.parts[rank] = part.to(torch.float32)
        self.barrier.wait()
        total = sum(self.parts[1:], self.parts[0].clone())
        self.barrier.wait()
        return total.to(part.dtype)

    def run(self, fn):
        """``fn(handle)`` on every rank; the results in rank order."""
        def rank(r):
            return fn(SimpleNamespace(rank=r, size=self.n,
                                      all_reduce_sum=lambda t: self.all_reduce_sum(r, t)))
        with ThreadPoolExecutor(self.n) as ex:
            return list(ex.map(rank, range(self.n)))


@pytest.mark.parametrize("name,n,layer", [("smoke", 2, 0), ("smoke", 4, 1),
                                          ("heads5x1", 2, 1)])
def test_block_partials_sum_to_reference_block(name, n, layer):
    """A prefill block from zero state over positions 100-163 (the meta
    positions below 128 stay visible as sinks; under the 32-slot window
    of an SWA layer the later queries lose keys 128 on): each rank runs the
    port's ``hymba_block`` on its shard, its attention, mamba and FFN
    partials summed over the ranks; every rank's output equals the
    reference's ``hymba_block``, its state shard the reference's state
    sliced by its SSM heads."""
    jcfg, tcfg, jp, tp = _params(name)
    rng = np.random.default_rng(9)
    s = 64
    x = rng.standard_normal((M, 1, s, jcfg.d_model)).astype(np.float32)
    is_global = layer in thyb.global_layers(tcfg)
    window = thyb.GLOBAL_WINDOW if is_global else thyb.swa_window(tcfg)
    pos = np.broadcast_to(100 + np.arange(s, dtype=np.int32), (M, 1, s))
    jlp = jax.tree.map(lambda t: t[layer], jp["layers"])
    want, _, wst = jhyb.hymba_block(jcfg, jlp, jnp.asarray(x), jnp.asarray(pos), window)
    nh_l, shd = thyb.ssm_heads(tcfg) // n, thyb.d_inner(tcfg) // thyb.ssm_heads(tcfg)

    def rank(h):
        lay = shardings.shard_params(tcfg, tp, h.rank, n)["layers"]
        lp = {k: lay[k][layer] for k in lay.keys()}
        split = shardings.hybrid_split(tcfg, h)
        per_q = thyb._kv_for_q(split, "cpu")
        xt, post = torch.from_numpy(x), torch.from_numpy(pos.copy())
        cos, sin = L.rope_tables(post, tcfg.head_dim, tcfg.rope_theta, torch.float32)

        def attend(xn):
            q, k, v = thyb._qkv(tcfg, lp, xn, cos, sin)
            o = L.flash_attention_plain(q, per_q(k), per_q(v), post, post, window=window,
                                        sink=R)
            return L.linear(o.reshape(M, 1, s, -1), lp["wo"])

        state = {"h": torch.zeros(M, 1, thyb.d_inner(tcfg) // n, tcfg.ssm_state),
                 "conv": torch.zeros(M, 1, tcfg.conv_kernel - 1, thyb.d_inner(tcfg))}
        return thyb.hymba_block(tcfg, lp, xt, attend, state, split=split), state

    for r, (got, state) in enumerate(_Lockstep(n).run(rank)):
        np.testing.assert_allclose(got.numpy(), _np(want), err_msg=f"rank {r}", **TOL)
        hs = _np(wst["h"]).reshape(M, 1, -1, shd, tcfg.ssm_state)[:, :, r * nh_l:(r + 1) * nh_l]
        np.testing.assert_allclose(state["h"].numpy(), hs.reshape(state["h"].shape), **TOL)
        np.testing.assert_allclose(state["conv"].numpy(), _np(wst["conv"]), **TOL)


# ---------------------------------------------------------------------------
# the engine in 2 and 4 gloo ranks against the JAX single-device engine
# ---------------------------------------------------------------------------

SERVER_KW = dict(slots_per_instance=2, max_context=192, prefill_chunk=16, prefill_lanes=3,
                 chunk_budget=3)
ENGINE_CASES = {"kv_T2": ("smoke", 2), "expand_T4": ("smoke", 4),
                "heads5x1_T2": ("heads5x1", 2)}
_RUNS = {}


def _requests(req_cls, vocab):
    """Prompts of 1 to 60 tokens (over the meta prefix, across the SWA
    ring), mixed budgets so lanes die mid-block at K=8."""
    rng = np.random.default_rng(11)
    return [req_cls(i % M, rng.integers(1, vocab, n).tolist(), 2 + i % 5)
            for i, n in enumerate((45, 1, 60, 7, 33, 20))]


def _jax_streams(name, k):
    if ("jax", name, k) not in _RUNS:
        jcfg, _, jp, _ = _params(name)
        srv = JServer(jcfg, jp, decode_steps=k, temperature=0.0, **SERVER_KW)
        for r in _requests(JRequest, jcfg.vocab_size):
            srv.submit(r)
        _RUNS["jax", name, k] = {r.request_id: r.tokens for r in srv.run_until_drained()}
    return _RUNS["jax", name, k]


def _rank_runs(case):
    """Both K in one spawn: per rank [K=1 run, K=8 run]."""
    if case not in _RUNS:
        name, n = ENGINE_CASES[case]
        _, tcfg, _, tp = _params(name)
        reqs = _requests(Request, tcfg.vocab_size)
        _RUNS[case] = mesh.spawn(
            mesh.in_turn, n,
            *((serve.serve_rank, tcfg, tp, reqs, dict(SERVER_KW, decode_steps=k)) for k in (1, 8)),
            device="cpu")
    return _RUNS[case]


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_streams_match_jax_single_device(case, k):
    """Every rank's greedy streams equal the JAX single-device engine's;
    the global layers' decode attention went through the sharded wrapper
    (CPU tensors: the plain version, so no launch is counted) and each
    rank's decode steps and chunk calls equal the others'."""
    name, _ = ENGINE_CASES[case]
    want = _jax_streams(name, k)
    assert want and all(want.values())
    runs = [r[0 if k == 1 else 1] for r in _rank_runs(case)]
    for r in runs:
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["streams"] == want
        assert r["launches"]["decode_attention_sharded"] == 0
        assert (r["decode_blocks"], r["prefill_calls"]) == (runs[0]["decode_blocks"],
                                                            runs[0]["prefill_calls"])


def test_serve_cli_hymba_mesh_1x2_on_cpu():
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                        "hymba-1.5b", "--smoke", "--device", "cpu", "--mesh-shape", "1x2",
                        "--requests", "6", "--decode-steps", "4"],
                       capture_output=True, text=True, timeout=300, cwd=str(REPO),
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "backend gloo" in r.stdout and "streams identical" in r.stdout
