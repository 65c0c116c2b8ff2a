"""The port's xLSTM (ssm family) against ``repro.models.ssm`` on the CPU.

Both packages get the same weights: ``repro.api.init`` on JAX's CPU,
carried across with ``checkpoint.bridge.params_from_numpy``.  The JAX
side runs its XLA path (``use_pallas_kernels=False``), never Pallas
interpret mode.  f32 xlstm-smoke config; tolerance 1e-5 relative and
absolute: both sides compute in f32 with the same rounding points, and
what is left is summation order (XLA's vs torch's matmuls, cumsum and
the decode step's rank-1 update), a few ulps compounded over the layers.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as japi
from repro.configs import registry as jreg
from repro.kernels import ref
from repro.models import ssm as jssm
from repro_torch import api as tapi
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops
from repro_torch.kernels import slstm_cell as sc
from repro_torch.models import common as C
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import KVCache

TOL = dict(rtol=1e-5, atol=1e-5)
M = 2


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_BOTH = {}


def _both():
    if not _BOTH:
        jcfg = jreg.get_smoke_config("xlstm-1.3b").with_(num_instances=M)
        tcfg = treg.get_smoke_config("xlstm-1.3b").with_(num_instances=M)
        jp = japi.init(jcfg, jax.random.PRNGKey(0))
        _BOTH["v"] = (jcfg, tcfg, jp,
                      params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu"))
    return _BOTH["v"]


def _np(x):
    return np.asarray(x, np.float32)


def _assert_tree(got, want, path="state"):
    """Every leaf of a port state tree against the reference's."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want), path
        for k in got:
            _assert_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(got, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree(g, w, f"{path}[{i}]")
    elif got is None:
        assert want is None, path
    else:
        np.testing.assert_allclose(got.float().numpy(), _np(want), err_msg=path, **TOL)


def _prefill_both(jcfg, tcfg, jp, tp, toks, lengths, c):
    """Chunk calls of width c over toks (M, 1, S), lane i valid up to
    lengths[i] (a padded final chunk where it ends mid-chunk)."""
    jcarry = japi.init_chunk_carry(jcfg, M, 1, 64)
    tcarry = tapi.init_chunk_carry(tcfg, M, 1, 64, device="cpu")
    jchunk = jax.jit(lambda p, b, cr, o: japi.prefill_chunk(jcfg, p, b, cr, o))
    for start in range(0, toks.shape[2], c):
        chunk = toks[:, :, start:start + c]
        valid = (start + np.arange(c)[None, None] < np.asarray(lengths)[:, None, None])
        off = np.full((M, 1), start, np.int32)
        jcarry = jchunk(jp, {"tokens": jnp.asarray(chunk), "valid": jnp.asarray(valid)},
                        jcarry, jnp.asarray(off))
        tapi.prefill_chunk(tcfg, tp, {"tokens": torch.from_numpy(chunk),
                                      "valid": torch.from_numpy(valid)},
                           tcarry, torch.from_numpy(off))
    return jcarry, tcarry


def test_params_cross_the_bridge_with_lists_and_storage_dtypes():
    jcfg, tcfg, jp, tp = _both()
    assert [r is None for r in tp["mlstm_runs"]] == [r is None for r in jp["mlstm_runs"]]
    assert len(tp["slstm"]) == len(jp["slstm"]) == 1
    np.testing.assert_array_equal(tp["slstm"][0]["r"].numpy(), _np(jp["slstm"][0]["r"]))
    # full config: layer matmul leaves in cfg.dtype, r and norms in param_dtype
    full = tssm.storage_dtypes(treg.get_config("xlstm-1.3b"), {
        "slstm": [{"r": torch.zeros(1), "w_in": torch.zeros(1), "norm": torch.zeros(1)}],
        "mlstm_runs": [None, {"wq": torch.zeros(1), "conv_w": torch.zeros(1)}]})
    assert full["slstm"][0]["r"].dtype == torch.float32
    assert full["slstm"][0]["norm"].dtype == torch.float32
    assert full["slstm"][0]["w_in"].dtype == torch.bfloat16
    assert full["mlstm_runs"][1]["conv_w"].dtype == torch.bfloat16
    assert full["mlstm_runs"][0] is None


def test_prefill_chunks_with_padded_final_chunk_and_decode_match():
    """Three chunks of 8 (lane 0 ends mid-chunk: a padded final chunk
    with ``valid``), then two decode steps: states and logits agree."""
    jcfg, tcfg, jp, tp = _both()
    rng = np.random.default_rng(0)
    toks = rng.integers(1, jcfg.vocab_size, (M, 1, 24)).astype(np.int32)
    jcarry, tcarry = _prefill_both(jcfg, tcfg, jp, tp, toks, [19, 24], 8)
    _assert_tree(tcarry["cache"], jcarry["cache"])

    jstate, tstate = jcarry["cache"], tcarry["cache"]
    jdecode = jax.jit(lambda p, st, t, ps: japi.decode_step(jcfg, p, st, t, ps))
    for step in range(2):
        tok = rng.integers(1, jcfg.vocab_size, (M, 1, 1)).astype(np.int32)
        pos = np.full((M, 1), 24 + step, np.int32)
        jlogits, jstate = jdecode(jp, jstate, jnp.asarray(tok), jnp.asarray(pos))
        tlogits, tstate = tapi.decode_step(tcfg, tp, tstate, torch.from_numpy(tok),
                                           torch.from_numpy(pos))
        np.testing.assert_allclose(tlogits.numpy(), _np(jlogits), **TOL)
        _assert_tree(tstate, jstate)
    jtok = jnp.argmax(jdecode(jp, jstate, jnp.asarray(tok), jnp.asarray(pos))[0], -1)
    ttok, _ = tapi.decode_step_sample(tcfg, tp, tstate, torch.from_numpy(tok),
                                      torch.from_numpy(pos))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_padded_chunk_carry_equals_exact_length():
    """Within the port: a prompt chunked 8 + 8 + 3-of-8 (padded) leaves
    the state of 8 + 8 + 3 -- the junk steps are neutral (the reference's
    padded-chunk test holds its own chunkings to the same tolerance: the
    intra-chunk matmuls differ in width)."""
    _, tcfg, _, tp = _both()
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(1, 257, (M, 1, 24)).astype(np.int32))

    def run(widths, pad):
        carry = tapi.init_chunk_carry(tcfg, M, 1, 64, device="cpu")
        start = 0
        for w in widths:
            t = toks[:, :, start:start + w]
            valid = torch.ones(t.shape, dtype=torch.bool)
            if pad and w < 8:
                t = torch.cat([t, torch.zeros(M, 1, 8 - w, dtype=t.dtype)], -1)
                valid = torch.arange(8)[None, None].expand(M, 1, 8) < w
            tapi.prefill_chunk(tcfg, tp, {"tokens": t, "valid": valid}, carry,
                               torch.full((M, 1), start, dtype=torch.int32))
            start += w
        return carry["cache"]

    for g, w in zip(C._leaves(run([8, 8, 3], True)), C._leaves(run([8, 8, 3], False))):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), **TOL)


def _cell_inputs(seed, m, b, s, h, hd, junk_from=None):
    rng = np.random.default_rng(seed)
    d = h * hd
    pre = rng.standard_normal((m, b, s, 4, d)).astype(np.float32)
    if junk_from is not None:
        for (mi, bi), t0 in junk_from.items():
            pre[mi, bi, t0:] = np.array([0.0, -1e30, 1e30, 0.0], np.float32)[:, None]
    r = (rng.standard_normal((m, 4, h, hd, hd)) / np.sqrt(hd)).astype(np.float32)
    state = (rng.standard_normal((m, b, d)).astype(np.float32),
             np.abs(rng.standard_normal((m, b, d))).astype(np.float32) + 0.5,
             (0.5 * rng.standard_normal((m, b, d))).astype(np.float32),
             rng.standard_normal((m, b, d)).astype(np.float32))
    return pre, r, state


@pytest.mark.parametrize("s", [1, 7])
def test_slstm_cell_plain_matches_ref_with_carried_state_and_junk(s):
    """A non-zero carried state; lane (0, 1) turns junk (neutral gates)
    after step 3, lane (1, 0) is junk throughout."""
    junk = {(0, 1): min(3, s - 1), (1, 0): 0}
    pre, r, state = _cell_inputs(2, 2, 3, s, 2, 16, junk)
    whs, wst = ref.slstm_cell(jnp.asarray(pre), jnp.asarray(r),
                              tuple(jnp.asarray(x) for x in state), num_heads=2)
    tstate = tuple(torch.from_numpy(x.copy()) for x in state)
    ops.reset_launches()
    ths, tst = ops.slstm_cell(torch.from_numpy(pre), torch.from_numpy(r), tstate,
                              num_heads=2)
    assert ops.launches()["slstm_cell"] == 0          # CPU tensors: the plain version
    assert all(a is b for a, b in zip(tst, tstate))   # updated in place
    np.testing.assert_allclose(ths.numpy(), _np(whs), **TOL)
    for g, w in zip(tst, wst):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)
    # a lane junk throughout keeps c, n and m bit for bit
    for i in (0, 1, 3):
        assert torch.equal(tst[i][1, 0], torch.from_numpy(state[i][1, 0]))


def test_slstm_cell_alive_freezes_dead_lanes():
    pre, r, state = _cell_inputs(3, 2, 2, 1, 2, 16)
    alive = torch.tensor([[True, False], [False, True]])
    st = tuple(torch.from_numpy(x.copy()) for x in state)
    sc.slstm_cell_plain(torch.from_numpy(pre), torch.from_numpy(r), st, num_heads=2,
                        alive=alive)
    for i in range(4):
        for mi, bi in ((0, 1), (1, 0)):
            assert torch.equal(st[i][mi, bi], torch.from_numpy(state[i][mi, bi]))
        assert not torch.equal(st[i][0, 0], torch.from_numpy(state[i][0, 0]))


def test_slstm_block_matches_reference_block_with_junk_steps():
    """The whole sLSTM block (norm, cell, h re-take at the last valid
    step, head norm, FFN) against ``repro.models.ssm.slstm_block``."""
    jcfg, tcfg, jp, tp = _both()
    rng = np.random.default_rng(5)
    d, s = jcfg.d_model, 6
    x = rng.standard_normal((M, 1, s, d)).astype(np.float32)
    valid = np.arange(s)[None, None] < np.array([4, 0])[:, None, None]
    st = {"c": rng.standard_normal((M, 1, d)), "n": np.abs(rng.standard_normal((M, 1, d))) + 1,
          "h": rng.standard_normal((M, 1, d)) * 0.3, "m": rng.standard_normal((M, 1, d))}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    jy, jst = jssm.slstm_block(jcfg, jp["slstm"][0], jnp.asarray(x),
                               state={k: jnp.asarray(v) for k, v in st.items()},
                               valid=jnp.asarray(valid))
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    ty = tssm.slstm_block(tcfg, tp["slstm"][0], torch.from_numpy(x), tst,
                          valid=torch.from_numpy(valid))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    for k in "cnhm":
        np.testing.assert_allclose(tst[k].numpy(), _np(jst[k]), **TOL)
    # lane 1 saw only junk: its whole state, h included, is what it was
    for k in "cnhm":
        assert torch.equal(tst[k][1], torch.from_numpy(st[k][1]))


@pytest.mark.parametrize("instances", [[1, 0, 1], [0, 0, 1, 1], [1, 1]])
def test_slstm_block_reads_r_through_rows_bit_for_bit(monkeypatch, instances):
    """A prefill chunk's lanes read the merged r through the row map
    (``rows``): the block's output and state equal, bit for bit, the same
    block fed a per-lane copy of r (the gathered form it replaced)."""
    from repro_torch.models import layers as TL

    jcfg, tcfg, jp, tp = _both()
    rng = np.random.default_rng(7)
    k, d, s = len(instances), tcfg.d_model, 5
    x = torch.from_numpy(rng.standard_normal((k, 1, s, d)).astype(np.float32))
    valid = torch.from_numpy(np.arange(s)[None, None] < rng.integers(1, s + 1, (k, 1, 1)))
    st0 = {"c": rng.standard_normal((k, 1, d)), "n": np.abs(rng.standard_normal((k, 1, d))) + 1,
           "h": rng.standard_normal((k, 1, d)) * 0.3, "m": rng.standard_normal((k, 1, d))}
    st0 = {n: torch.from_numpy(v.astype(np.float32)) for n, v in st0.items()}
    groups = TL.LaneGroups(instances, M, "cpu")
    st_map = {n: v.clone() for n, v in st0.items()}
    y_map = tssm.slstm_block(tcfg, tp["slstm"][0], x, st_map, valid=valid, groups=groups)

    seen, cell = [], ops.slstm_cell

    def gathered_cell(pre, r, state, *, num_heads, alive=None, rows=None):
        seen.append(rows)
        return cell(pre, r.index_select(0, rows.long()), state, num_heads=num_heads, alive=alive)

    monkeypatch.setattr(tssm.K, "slstm_cell", gathered_cell)
    st_cat = {n: v.clone() for n, v in st0.items()}
    y_cat = tssm.slstm_block(tcfg, tp["slstm"][0], x, st_cat, valid=valid, groups=groups)
    assert seen and seen[0].tolist() == instances
    assert torch.equal(y_map, y_cat)
    assert all(torch.equal(st_map[n], st_cat[n]) for n in "cnhm")
    # the plain cell itself: rows against the gathered copy
    pre = torch.from_numpy(rng.standard_normal((k, 1, s, 4, d)).astype(np.float32))
    r = tp["slstm"][0]["r"]
    rows = torch.tensor(instances, dtype=torch.int32)
    a = tuple(v.clone() for v in st0.values())
    b = tuple(v.clone() for v in st0.values())
    ha, _ = sc.slstm_cell_plain(pre, r, a, num_heads=tcfg.num_heads, rows=rows)
    hb, _ = sc.slstm_cell_plain(pre, r.index_select(0, rows.long()), b, num_heads=tcfg.num_heads)
    assert torch.equal(ha, hb) and all(torch.equal(u, v) for u, v in zip(a, b))


def test_mlstm_step_alive_freezes_dead_lanes():
    rng = np.random.default_rng(6)
    m, b, h, hd = 2, 2, 2, 8
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    state = (r(m, b, h, hd, hd), r(m, b, h, hd), r(m, b, h))
    before = tuple(t.clone() for t in state)
    alive = torch.tensor([[True, False], [False, True]])
    tssm.mlstm_step_(state, r(m, b, h, hd), r(m, b, h, hd), r(m, b, h, hd),
                     -r(m, b, h).abs(), r(m, b, h), alive)
    for new, old in zip(state, before):
        assert torch.equal(new[0, 1], old[0, 1]) and torch.equal(new[1, 0], old[1, 0])
        assert not torch.equal(new[0, 0], old[0, 0])


def test_axes_driven_surgery_on_kv_cache_and_ssm_state():
    """take/put/select through the axes trees: the dense KV cache (context
    axis prefix-clipped) and the ssm state (sLSTM leaves (M, B, D), mLSTM
    leaves (L, M, B, ...) with no context axis, a None run)."""
    dense = treg.get_smoke_config("tinyllama-1.1b")
    shape = (2, 3, 2, 5, 1, 4)
    grid = KVCache(torch.zeros(shape), torch.zeros(shape))
    src = KVCache(torch.arange(2 * 2 * 1 * 7 * 4.0).reshape(2, 2, 1, 7, 1, 4),
                  torch.ones(2, 2, 1, 7, 1, 4))
    tapi.put_state(dense, grid, tapi.take_state(dense, src, 1, 0), 2, 1)
    assert torch.equal(grid.k[:, 2, 1], src.k[:, 1, 0, :5])
    assert grid.k[:, :2].eq(0).all() and grid.v[:, 2, 0].eq(0).all()

    cfg = treg.get_smoke_config("xlstm-1.3b").with_(num_layers=6, slstm_every=3,
                                                     slstm_offset=2)  # runs [2, 2, 0]
    ax = tapi.cache_axes(cfg)
    a = tapi.make_cache(cfg, 3, 2, 0, device="cpu")
    b = C.tree_map(lambda t: torch.rand_like(t.float()).to(t.dtype), a)
    one = tapi.take_state(cfg, b, 2, 0)
    assert one["slstm"][0]["c"].shape == (1, 1, cfg.d_model)
    assert one["mlstm_runs"][1]["C"].shape[:3] == (2, 1, 1)
    assert one["slstm"][0]["c"].data_ptr() == b["slstm"][0]["c"][2, 0].data_ptr()
    tapi.put_state(cfg, a, one, 1, 1)
    assert torch.equal(a["slstm"][0]["h"][1, 1], b["slstm"][0]["h"][2, 0])
    assert torch.equal(a["mlstm_runs"][1]["conv"][:, 1, 1], b["mlstm_runs"][1]["conv"][:, 2, 0])
    assert a["slstm"][0]["c"][0].eq(0).all() and a["mlstm_runs"][0]["C"][:, 2].eq(0).all()
    assert a["mlstm_runs"][2] is None and tapi.take_state(cfg, a, 0, 0)["mlstm_runs"][2] is None

    lanes = C.tree_select_lanes(torch.tensor([True, False, True]), b, a, ax)
    assert torch.equal(lanes["slstm"][0]["m"][1], a["slstm"][0]["m"][1])
    assert torch.equal(lanes["mlstm_runs"][1]["C"][:, 2], b["mlstm_runs"][1]["C"][:, 2])
    mask = torch.tensor([[True, False]] * 3)
    slots = C.tree_select_slots(mask, b, a, ax)
    assert torch.equal(slots["mlstm_runs"][0]["n"][:, :, 0], b["mlstm_runs"][0]["n"][:, :, 0])
    assert torch.equal(slots["slstm"][0]["n"][:, 1], a["slstm"][0]["n"][:, 1])
    new = KVCache(torch.ones(shape), torch.ones(shape))
    dslots = C.tree_select_slots(mask, new, grid, tapi.cache_axes(dense))
    assert dslots.k[:, :, 0].eq(1).all() and torch.equal(dslots.k[:, :, 1], grid.k[:, :, 1])
    dlanes = C.tree_select_lanes(torch.tensor([False, True, False]), new, grid,
                                 tapi.cache_axes(dense))
    assert dlanes.v[:, 1].eq(1).all() and torch.equal(dlanes.v[:, 2], grid.v[:, 2])

    init = tapi.init_chunk_carry(cfg, 1, 1, 0, device="cpu")
    carry = {"cache": b}
    C.tree_reset_lanes(carry, init, tapi.chunk_carry_axes(cfg), [0, 2])
    assert b["slstm"][0]["m"][0].eq(-1e30).all() and b["slstm"][0]["m"][2].eq(-1e30).all()
    assert b["mlstm_runs"][1]["C"][:, 2].eq(0).all()
    assert not b["slstm"][0]["c"][1].eq(0).all()


def test_engine_long_prompts_match_jax_engine():
    """Prompts over several chunks with a per-step chunk budget, so lanes
    finish at different calls of one ``advance`` and ride the later calls
    as junk, and a single-token prompt in the same batch: greedy streams
    and device-call counts equal the JAX engine's."""
    from repro.serving import MultiModelServer as JServer
    from repro.serving import Request as JRequest
    from repro_torch.serving import MultiModelServer, Request

    jcfg, tcfg, jp, tp = _both()
    rng = np.random.default_rng(7)
    reqs = [(i % 2, rng.integers(1, 257, n).tolist(), 4)
            for i, n in enumerate((19, 1, 33, 6, 26, 12))]
    kw = dict(slots_per_instance=2, max_context=64, temperature=0.0, prefill_chunk=8,
              prefill_lanes=3, chunk_budget=3, decode_steps=8)

    def drain(srv, req_cls):
        for inst, prompt, n in reqs:
            srv.submit(req_cls(inst, list(prompt), n))
        out = {r.request_id: r.tokens for r in srv.run_until_drained()}
        return out, srv.steps, srv.prefill.device_calls

    want = drain(JServer(jcfg, jp, **kw), JRequest)
    got = drain(MultiModelServer(tcfg, tp, device="cpu", **kw), Request)
    assert len(want[0]) == len(reqs) and got == want
