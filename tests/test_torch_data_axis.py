"""The data axis of the port's serving mesh (``--mesh-shape DxT``, D > 1),
on the CPU, against the JAX package.

The rules are held against the reference's own on a stub mesh (a
``SimpleNamespace`` with the mesh's ``shape``): ``data_split`` against
``serve_rules(mesh).spec(("instances", "batch"), (M, B))``, the blocks of
``fused_matmul_sharded`` against the specs the reference's wrapper builds
(``repro/kernels/fused_matmul.py:143-153``), and the scheduler's picks and
shard map against ``repro.serving.scheduler.make_scheduler(policy, M,
mesh=stub)``.  The ranks' ``fused_matmul_sharded`` blocks, reassembled,
are held against the reference's Pallas kernel in interpret mode at
rtol/atol 2e-5 (f32; the reference's own tolerance for its sharded
matmul).  The engine runs in real rank processes (``mesh.spawn``, gloo),
one spawn per mesh shape, and every rank's greedy streams must equal the
JAX package's single-device engine's (f32): the data axis changes which
rows a rank computes, never a token.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import registry as jreg
from repro.kernels.fused_matmul import fused_matmul as ref_fused_matmul
from repro.launch.shardings import serve_rules
from repro.serving import MultiModelServer as JServer
from repro.serving import Request as JRequest
from repro.serving.scheduler import make_scheduler as ref_make_scheduler
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.kernels import fused_matmul as fm
from repro_torch.kernels import ops
from repro_torch.launch import mesh, serve, tp_parity
from repro_torch.models import shardings
from repro_torch.serving import Request
from repro_torch.serving.scheduler import make_scheduler

MATMUL_TOL = dict(rtol=2e-5, atol=2e-5)
MESHES = [(1, 2), (2, 1), (2, 2)]
# (seed, M, T, D, F): the instances and F split where they divide; M=3
# and F=77 divide neither 2-way axis and replicate
MATMUL_SHAPES = [(0, 4, 3, 16, 24), (1, 3, 5, 16, 77)]


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _stub(d, t=2):
    return SimpleNamespace(shape={"data": d, "model": t})


# ---------------------------------------------------------------------------
# the rules against the reference's on a stub mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_data_split_matches_reference_rules(d):
    """``data_split`` is the reference's spec of the (M, B) grid, and the
    data ranks' blocks tile the grid."""
    rules = serve_rules(_stub(d))
    for m in range(1, 9):
        for b in range(1, 9):
            inst, batch = tuple(rules.spec(("instances", "batch"), (m, b)))
            want = "instances" if inst == "data" else "batch" if batch == "data" else None
            assert shardings.data_split(m, b, d) == want, (m, b, d)
            grid = np.arange(m * b).reshape(m, b)
            blocks = [shardings.data_rows(m, b, SimpleNamespace(rank=i, size=d)).block(grid)
                      for i in range(d)]
            if want is None:
                assert all(np.array_equal(x, grid) for x in blocks)
            else:
                axis = 0 if want == "instances" else 1
                assert np.array_equal(np.concatenate(blocks, axis), grid)


@pytest.mark.parametrize("d,t", MESHES + [(4, 3)])
def test_fused_matmul_sharded_specs_match_reference(d, t):
    rules = serve_rules(_stub(d, t))
    for m in (1, 2, 3, 4, 6, 12):
        for f in (24, 36, 77, 96):
            tt, dd = 5, 16
            want = {"x": rules.spec(("instances", None, None), (m, tt, dd)),
                    "w": rules.spec(("instances", None, "mlp"), (m, dd, f)),
                    "b": rules.spec(("instances", "mlp"), (m, f)),
                    "out": rules.spec(("instances", None, "mlp"), (m, tt, f))}
            got = fm.sharded_specs(m, f, d, t)
            assert got == {k: tuple(v) for k, v in want.items()}, (m, f, d, t)


_REF = {}


def _matmul_case(shape, bias):
    """The seeded whole problem and the reference kernel's output on it."""
    key = (shape, bias)
    if key not in _REF:
        x, w, b = tp_parity.matmul_problem(*shape, torch.float32, bias)
        _REF[key] = (x, w, b, np.asarray(ref_fused_matmul(
            jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
            None if b is None else jnp.asarray(b.numpy()), interpret=True)))
    return _REF[key]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape", MATMUL_SHAPES, ids=lambda s: f"M{s[1]}F{s[4]}")
@pytest.mark.parametrize("d,t", MESHES)
def test_fused_matmul_sharded_blocks_match_reference(d, t, shape, bias):
    """Every rank's block through ``ops.fused_matmul_sharded`` (in this
    process, the plain version on the CPU), reassembled, equals the
    reference's Pallas kernel on the whole arrays."""
    x, w, b, want = _matmul_case(shape, bias)
    outs = []
    for g in range(d * t):
        data, tp = SimpleNamespace(rank=g // t, size=d), SimpleNamespace(rank=g % t, size=t)
        xl, wl, bl = fm.rank_block(x, w, b, data.rank, d, tp.rank, t)
        if fm.sharded_specs(shape[1], shape[4], d, t)["w"][2]:
            assert wl.shape[2] == shape[4] // t
        outs.append(ops.fused_matmul_sharded(xl, wl, bl, data=data, tp=tp))
    got = fm.assemble(outs, shape[1], shape[4], d, t)
    np.testing.assert_allclose(got.numpy(), want, **MATMUL_TOL)
    assert ops.launches()["fused_matmul_sharded"] == 0


def test_random_merged_rows_move_between_devices():
    """``random_merged`` draws only the given instance rows, the same
    weights as the whole draw, as parameters that survive ``.to()``
    swapping their data (a parameter made in inference mode does not:
    the first view of it raises)."""
    cfg = treg.get_smoke_config("tinyllama-1.1b").with_(num_instances=4)
    whole = serve.random_merged(cfg, 3, torch.device("cpu"))[0]
    rows = serve.random_merged(cfg, 3, torch.device("cpu"), rows=range(2, 4))[0]
    assert torch.equal(rows["layers"]["wq"], whole["layers"]["wq"][:, 2:4])
    assert torch.equal(rows["embed"], whole["embed"][2:4])
    rows._apply(lambda t: t.clone())           # what a move to the card does
    with torch.inference_mode():
        assert rows["embed"][1][torch.tensor([1, 2])].shape == (2, cfg.d_model)


def test_data_params_take_the_rows_the_first_instance_names():
    """Whole params are cut to the rank's rows; params that start at the
    rank's first instance pass as they are; params that do not hold the
    rank's rows raise instead of being taken for them."""
    cfg = treg.get_smoke_config("tinyllama-1.1b").with_(num_instances=4)
    whole = serve.random_merged(cfg, 3, torch.device("cpu"))[0]
    own = serve.random_merged(cfg, 3, torch.device("cpu"), rows=range(2, 4))[0]
    rows = shardings.data_rows(4, 2, SimpleNamespace(rank=1, size=2))
    assert torch.equal(shardings.data_params(whole, rows)["layers"]["wq"],
                       own["layers"]["wq"])
    assert shardings.data_params(own, rows, first=2) is own
    with pytest.raises(ValueError, match="this rank needs"):
        shardings.data_params(own, rows)


# ---------------------------------------------------------------------------
# the scheduler against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["fifo", "round-robin", "token-budget"])
@pytest.mark.parametrize("m,d", [(4, 2), (4, 4), (3, 2), (6, 3)])
def test_scheduler_matches_reference_on_a_mesh(policy, m, d):
    """One seeded trace of submits, selects and ``note_generated``: the
    same requests picked in the same order, the same shard map."""
    shards = d if shardings.data_split(m, 2, d) == "instances" else 1
    ours = make_scheduler(policy, m, shards)
    ref = ref_make_scheduler(policy, m, mesh=_stub(d))
    assert ours.num_data_shards == ref.num_data_shards
    assert [ours.data_shard_of(i) for i in range(m)] == [ref.data_shard_of(i) for i in range(m)]
    rng = np.random.default_rng(5)
    rid = 0
    for _ in range(40):
        for _ in range(int(rng.integers(0, 4))):
            inst, n = int(rng.integers(0, m)), int(rng.integers(1, 4))
            for s, cls in ((ours, Request), (ref, JRequest)):
                s.submit(cls(inst, [1] * n, 4, request_id=rid))
            rid += 1
        free = {i: int(rng.integers(0, 3)) for i in range(m)}
        limit = int(rng.integers(1, 5))
        got = [(r.instance, r.request_id) for r in ours.select(free, limit=limit)]
        assert got == [(r.instance, r.request_id) for r in ref.select(free, limit=limit)]
        for _ in range(int(rng.integers(0, 6))):
            inst, n = int(rng.integers(0, m)), int(rng.integers(1, 3))
            ours.note_generated(inst, n)
            ref.note_generated(inst, n)
    assert rid > 40


# ---------------------------------------------------------------------------
# the engine on 2x1 and 2x2 gloo meshes against the JAX single-device engine
# ---------------------------------------------------------------------------

DENSE_KW = dict(slots_per_instance=2, max_context=64, prefill_chunk=8, prefill_lanes=3,
                chunk_budget=3)
# name -> (arch, overrides, server settings): M=2 splits the instances
# over 2 data ranks; M=3 with 2 slots splits the slots ("batch")
CONFIGS = {
    "dense": ("tinyllama-1.1b", dict(num_instances=2, vocab_size=256), DENSE_KW),
    "dense_m3": ("tinyllama-1.1b", dict(num_instances=3, vocab_size=256), DENSE_KW),
    "ssm": ("xlstm-1.3b", dict(num_instances=2), DENSE_KW),
    "hybrid": ("hymba-1.5b", dict(num_instances=2, num_layers=4),
               dict(DENSE_KW, max_context=192, prefill_chunk=16)),
}
_PARAMS, _RUNS = {}, {}


def _params(name):
    if name not in _PARAMS:
        arch, kw, _ = CONFIGS[name]
        jcfg = jreg.get_smoke_config(arch).with_(**kw)
        tcfg = treg.get_smoke_config(arch).with_(**kw)
        jp = japi.init(jcfg, jax.random.PRNGKey(0))
        _PARAMS[name] = (jcfg, tcfg, jp,
                         params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu"))
    return _PARAMS[name]


def _requests(req_cls, cfg):
    """Prompts of 1 to 45 tokens over several chunks and mixed budgets, so
    lanes finish at different calls and slots stop mid-block at K=8."""
    rng = np.random.default_rng(3)
    return [req_cls(i % cfg.num_instances, rng.integers(1, cfg.vocab_size, n).tolist(),
                    2 + i % 6)
            for i, n in enumerate((19, 1, 33, 6, 45, 12, 26, 3))]


def _jax_streams(name, k):
    if (name, k) not in _RUNS:
        jcfg, _, jp, _ = _params(name)
        srv = JServer(jcfg, jp, decode_steps=k, temperature=0.0, **CONFIGS[name][2])
        for r in _requests(JRequest, jcfg):
            srv.submit(r)
        _RUNS[name, k] = {r.request_id: r.tokens for r in srv.run_until_drained()}
    return _RUNS[name, k]


# the runs of each mesh shape, in one spawn: (config, K)
MESH_RUNS = {(2, 1): [("dense", 1), ("dense", 8), ("dense_m3", 8), ("ssm", 8)],
             (2, 2): [("dense", 1), ("dense", 8), ("hybrid", 8)]}


def _mesh_runs(d, t):
    """Per rank: {(config, K): serve_rank's result, ("matmul", shape):
    fused_matmul_rank's result}."""
    if (d, t) not in _RUNS:
        calls = [(serve.serve_rank, _params(n)[1], _params(n)[3],
                  _requests(Request, _params(n)[1]), dict(CONFIGS[n][2], decode_steps=k))
                 for n, k in MESH_RUNS[d, t]]
        calls += [(tp_parity.fused_matmul_rank, (*s, torch.float32, True)) for s in MATMUL_SHAPES]
        keys = MESH_RUNS[d, t] + [("matmul", s) for s in MATMUL_SHAPES]
        ranks = mesh.spawn(mesh.in_turn, t, *calls, device="cpu", data=d)
        _RUNS[d, t] = [dict(zip(keys, r)) for r in ranks]
    return _RUNS[d, t]


ENGINE_CASES = [(d, t, n, k) for (d, t), runs in sorted(MESH_RUNS.items()) for n, k in runs]


@pytest.mark.parametrize("d,t,name,k", ENGINE_CASES,
                         ids=[f"{d}x{t}-{n}-K{k}" for d, t, n, k in ENGINE_CASES])
def test_engine_streams_match_jax_single_device(d, t, name, k):
    """Every rank's greedy streams equal the JAX single-device engine's; the
    ranks made the same device calls and record the mesh.  2x1 and 2x2:
    dense at K=1 and 8 (the instances split); 2x1: dense at M=3, B=2 (the
    slots split) and ssm; 2x2: hybrid."""
    want = _jax_streams(name, k)
    assert want and all(want.values())
    runs = [r[name, k] for r in _mesh_runs(d, t)]
    for r in runs:
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["streams"] == want
        assert (r["decode_blocks"], r["prefill_calls"]) == (runs[0]["decode_blocks"],
                                                            runs[0]["prefill_calls"])
        assert r["snapshot"]["mesh"] == {"shape": {"data": d, "model": t}, "devices": d * t}


@pytest.mark.parametrize("d,t", sorted(MESH_RUNS))
def test_fused_matmul_sharded_in_ranks(d, t):
    """Each rank of the spawn cut its block and ran the wrapper (plain on
    the CPU: no launch); the blocks reassemble to the reference kernel's
    output."""
    ranks = _mesh_runs(d, t)
    for shape in MATMUL_SHAPES:
        outs = [r["matmul", shape] for r in ranks]
        assert all(o["launches"] == 0 for o in outs)
        got = fm.assemble([o["out"] for o in outs], shape[1], shape[4], d, t)
        np.testing.assert_allclose(got.numpy(), _matmul_case(shape, True)[3], **MATMUL_TOL)
