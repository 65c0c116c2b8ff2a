"""The port's dense model against ``repro.models.dense`` on the CPU.

Both packages get the same weights: ``repro.api.init`` on JAX's CPU,
carried across with ``checkpoint.bridge.params_from_numpy``.  The JAX
side runs its plain XLA path (``use_pallas_kernels=False``).  f32 smoke
configs; tolerance 1e-4 absolute and relative: summation orders differ
(XLA vs torch matmuls, the reference's online-softmax flash attention vs
the port's one-pass softmax) and compound over two layers.  Greedy
tokens are compared exactly.
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
from repro_torch.models.common import gather_instances, merge_instances
from repro_torch.core.merge import num_instances, stack_instances, unstack_instances

ARCHS = ["tinyllama-1.1b", "qwen1.5-0.5b", "granite-3-2b"]
TOL = dict(rtol=1e-4, atol=1e-4)
M = 2


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _both(arch):
    jcfg = jreg.get_smoke_config(arch).with_(num_instances=M)
    tcfg = treg.get_smoke_config(arch).with_(num_instances=M)
    jparams = japi.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunks_with_tail_fold_match(arch):
    """Three chunks of 8, the last padded past the prompt's end (tail
    folding): the caches agree."""
    jcfg, tcfg, jp, tp = _both(arch)
    ctx, c, plen = 48, 8, 21
    rng = np.random.default_rng(0)
    toks = rng.integers(1, jcfg.vocab_size, (M, 1, 24)).astype(np.int32)
    jcarry = japi.init_chunk_carry(jcfg, M, 1, ctx)
    tcarry = tapi.init_chunk_carry(tcfg, M, 1, ctx, device="cpu")
    for start in range(0, 24, c):
        chunk = toks[:, :, start:start + c]
        valid = (start + np.arange(c) < plen)[None, None].repeat(M, 0)
        off = np.full((M, 1), start, np.int32)
        jcarry = japi.prefill_chunk(
            jcfg, jp, {"tokens": jnp.asarray(chunk), "valid": jnp.asarray(valid)},
            jcarry, jnp.asarray(off))
        tapi.prefill_chunk(tcfg, tp, {"tokens": torch.from_numpy(chunk),
                                      "valid": torch.from_numpy(valid)},
                           tcarry, torch.from_numpy(off))
    for g, w in zip(tcarry["cache"], jcarry["cache"]):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)
    # the padded junk never reached the cache
    assert not tcarry["cache"].k[:, :, :, plen:].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_and_sample_match(arch):
    jcfg, tcfg, jp, tp = _both(arch)
    ctx = 24
    rng = np.random.default_rng(1)
    ck = (rng.standard_normal((jcfg.num_layers, M, 2, ctx, jcfg.num_kv_heads,
                               jcfg.head_dim)) * 0.5).astype(np.float32)
    cv = (rng.standard_normal(ck.shape) * 0.5).astype(np.float32)
    tok = np.array([[1, 2], [3, 4]], np.int32)[..., None]
    pos = np.array([[5, 9], [0, 30]], np.int32)
    from repro.models.layers import KVCache as JKV
    from repro_torch.models.layers import KVCache as TKV

    jcache = JKV(jnp.asarray(ck), jnp.asarray(cv))
    jlogits, jnew = japi.decode_step(jcfg, jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
    tcache = TKV(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
    tlogits, tnew = tapi.decode_step(tcfg, tp, tcache, torch.from_numpy(tok),
                                     torch.from_numpy(pos))
    np.testing.assert_allclose(tlogits.numpy(), _np(jlogits), **TOL)
    for g, w in zip(tnew, jnew):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)

    jtok, _ = japi.decode_step_sample(jcfg, jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
    tcache = TKV(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
    ttok, _ = tapi.decode_step_sample(tcfg, tp, tcache, torch.from_numpy(tok),
                                      torch.from_numpy(pos))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("instances", [[1, 0], [1, 1], [0, 1]])
def test_prefill_lane_instances_match_gathered_model(instances):
    """Prefill lanes reading chosen instances through views (a permutation,
    a shared instance, the identity) equal the same chunk on a model
    gathered to those instances."""
    _, tcfg, _, tp = _both("qwen1.5-0.5b")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(1, tcfg.vocab_size, (M, 1, 8)).astype(np.int32))
    off = torch.tensor([[3], [0]], dtype=torch.int32)
    batch = {"tokens": toks, "valid": torch.ones(M, 1, 8, dtype=torch.bool)}
    got = tapi.init_chunk_carry(tcfg, M, 1, 16, device="cpu")
    tapi.prefill_chunk(tcfg, tp, batch, got, off, instances=instances)
    want = tapi.init_chunk_carry(tcfg, M, 1, 16, device="cpu")
    tapi.prefill_chunk(tcfg, gather_instances(tp, instances), batch, want, off)
    for g, w in zip(got["cache"], want["cache"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)


def test_merge_and_gather_instances():
    """merge_instances stacks single-instance models on the right axis;
    gather_instances picks rows; stack/unstack round-trip."""
    tcfg = treg.get_smoke_config("qwen1.5-0.5b").with_(num_instances=1)
    ones = [tapi.init(tcfg, torch.Generator().manual_seed(i), "cpu") for i in range(3)]
    merged = merge_instances(ones)
    assert merged["layers"]["wq"].shape[:2] == (tcfg.num_layers, 3)
    assert merged["embed"].shape[0] == 3
    assert torch.equal(merged["layers"]["bq"][:, 2], ones[2]["layers"]["bq"][:, 0])
    picked = gather_instances(merged, [2, 0])
    assert torch.equal(picked["lm_head"][0], ones[2]["lm_head"][0])
    assert torch.equal(picked["layers"]["w_up"][:, 1], ones[0]["layers"]["w_up"][:, 0])
    stacked = stack_instances([o.tree() for o in ones])
    assert num_instances(stacked) == 3
    back = unstack_instances(stacked)
    assert torch.equal(back[1]["final_norm"], ones[1]["final_norm"])
    with pytest.raises(ValueError, match="different architectures"):
        stack_instances([ones[0].tree(), {"final_norm": torch.zeros(2)}])


def test_lane_and_slot_surgery():
    """tree_select_lanes / tree_select_slots pick per lane / per slot;
    take_state is a view of one slot and put_state writes it back,
    prefix-clipping the context axis."""
    from repro_torch.models.common import tree_select_lanes, tree_select_slots
    from repro_torch.models.layers import KVCache

    shape = (2, 3, 2, 5, 1, 4)                     # (L, M, B, S, KVH, hd)
    old = KVCache(torch.zeros(shape), torch.zeros(shape))
    new = KVCache(torch.ones(shape), torch.ones(shape))
    cfg = treg.get_smoke_config("tinyllama-1.1b")
    ax = tapi.cache_axes(cfg)
    lanes = tree_select_lanes(torch.tensor([True, False, True]), new, old, ax)
    assert lanes.k[:, 0].eq(1).all() and lanes.k[:, 1].eq(0).all()
    slots = tree_select_slots(torch.tensor([[True, False]] * 3), new, old, ax)
    assert slots.v[:, :, 0].eq(1).all() and slots.v[:, :, 1].eq(0).all()

    grid = KVCache(torch.zeros(shape), torch.zeros(shape))
    src = KVCache(torch.arange(2 * 2 * 1 * 7 * 4.0).reshape(2, 2, 1, 7, 1, 4),
                  torch.zeros(2, 2, 1, 7, 1, 4))
    one = tapi.take_state(cfg, src, 1, 0)
    assert one.k.shape == (2, 1, 1, 7, 1, 4)
    assert one.k.untyped_storage().data_ptr() == src.k.untyped_storage().data_ptr()
    tapi.put_state(cfg, grid, one, 2, 1)
    assert torch.equal(grid.k[:, 2, 1], src.k[:, 1, 0, :5])
    assert grid.k[:, :2].eq(0).all() and grid.k[:, 2, 0].eq(0).all()


def test_init_draws_reference_distributions():
    """fan_in leaves have std 1/sqrt(fan_in), embed 0.02, norms ones."""
    tcfg = treg.get_smoke_config("tinyllama-1.1b").with_(num_instances=2)
    p = tapi.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert abs(p["layers"]["w_gate"].std().item() * np.sqrt(tcfg.d_model) - 1) < 0.05
    assert abs(p["embed"].std().item() / 0.02 - 1) < 0.05
    assert torch.equal(p["final_norm"], torch.ones_like(p["final_norm"]))
