"""The port's op-graph IR and Algorithm 1 (``repro_torch.core.graph``) held
against the reference's (``repro.core.graph``): the five cases of
``tests/test_core_graph.py`` run through both packages on the same
numpy-seeded weights, in f32.  The merged graphs must agree op for op
(names, types, inputs, attrs, concat dims, the inserted ``merge_reshape``
nodes), the port's merged run must equal its per-instance runs, and its
outputs must match the reference's within rtol = atol = 2e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro_torch.core import graph as TG

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(rng, *shape):
    return (rng.standard_normal(shape) * 0.1).astype(np.float32)


def _both(build):
    """The same graph built in each package."""
    return build(JG.Graph()), build(TG.Graph())


def _ffnn(g):
    """The paper's Figure 4: FC -> LayerNorm -> GELU -> FC."""
    g.add("x", "input")
    g.add("fc1", "matmul", ["x"])
    g.add("ln", "layernorm", ["fc1"])
    g.add("act", "gelu", ["ln"])
    g.add("fc2", "matmul", ["act"])
    g.outputs = ["fc2"]
    return g


def _ffnn_weights(rng, d_in=12, d_hidden=16, d_out=8):
    return {"fc1": {"w": _rand(rng, d_in, d_hidden), "b": _rand(rng, d_hidden)},
            "ln": {"scale": 1.0 + _rand(rng, d_hidden), "bias": _rand(rng, d_hidden)},
            "fc2": {"w": _rand(rng, d_hidden, d_out), "b": _rand(rng, d_out)}}


def _cnn(g):
    """conv -> BN -> relu -> conv (residual add) -> pool -> GAP -> fc."""
    g.add("img", "input")
    g.add("conv1", "conv2d", ["img"], stride=1, padding="SAME")
    g.add("bn1", "batchnorm", ["conv1"])
    g.add("relu1", "relu", ["bn1"])
    g.add("conv2", "conv2d", ["relu1"], stride=1, padding="SAME")
    g.add("res", "add", ["conv2", "relu1"])
    g.add("pool", "maxpool2d", ["res"], kernel=2)
    g.add("gap", "global_avgpool", ["pool"])
    g.add("fc", "matmul", ["gap"])
    g.outputs = ["fc"]
    return g


def _cnn_weights(rng, cin=3, c=8, n_class=5):
    return {"conv1": {"w": _rand(rng, 3, 3, cin, c), "b": _rand(rng, c)},
            "bn1": {"mean": _rand(rng, c), "var": np.abs(_rand(rng, c)) + 0.5,
                    "scale": 1.0 + _rand(rng, c), "bias": _rand(rng, c)},
            "conv2": {"w": _rand(rng, 3, 3, c, c)},
            "fc": {"w": _rand(rng, c, n_class)}}


def _grouped(g):
    g.add("x", "input")
    g.add("gconv", "conv2d", ["x"], groups=2)
    g.outputs = ["gconv"]
    return g


def _majority(g):
    g.add("x", "input")
    g.add("fc", "matmul", ["x"])        # Batch
    g.add("ln1", "layernorm", ["fc"])   # Channel
    g.add("ln2", "layernorm", ["fc"])   # Channel
    g.add("sum", "add", ["ln1", "ln2"])  # DontCare -> Channel (majority)
    g.outputs = ["sum"]
    return g


def _jnp_tree(tree):
    return {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in tree.items()}


def _check_case(build, weights, inputs, tol=TOL):
    """Both merges agree op for op, the port's merged run equals its
    per-instance runs, and both equal the reference's.  Returns the
    port's (merged graph, dims)."""
    jg, tg = _both(build)
    jm, jmw, jdims = JG.merge_graph(jg, [_jnp_tree(w) for w in weights])
    tm, tmw, tdims = TG.merge_graph(tg, weights, device="cpu")
    assert list(tm.ops) == list(jm.ops) and tm.outputs == jm.outputs
    for name, op in tm.ops.items():
        ref = jm.ops[name]
        assert (op.op_type, op.inputs, op.attrs) == (ref.op_type, ref.inputs, ref.attrs), name
    assert {k: v.value for k, v in tdims.items()} == {k: v.value for k, v in jdims.items()}
    assert set(tmw) == set(jmw)
    for name, w in tmw.items():
        assert set(w) == set(jmw[name])
        for k, v in w.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jmw[name][k]))

    fused = TG.execute_merged(tm, tmw, tdims, inputs, device="cpu")
    jfused = JG.execute_merged(jm, jmw, jdims, [_jnp_tree({"i": i})["i"] for i in inputs])
    for i, (w, x) in enumerate(zip(weights, inputs)):
        ref = TG.execute(tg, x, w, device="cpu")
        jref = JG.execute(jg, _jnp_tree({"i": x})["i"], _jnp_tree(w))
        for o in tg.outputs:
            got = fused[i][o]
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), ref[o].numpy(), **tol)
            np.testing.assert_allclose(got.numpy(), np.asarray(jfused[i][o]), **tol)
            np.testing.assert_allclose(ref[o].numpy(), np.asarray(jref[o]), **tol)
    return tm, tdims


@pytest.mark.parametrize("m", [2, 4, 8])
def test_ffnn_merge_exact(m):
    rng = np.random.default_rng(m)
    weights = [_ffnn_weights(rng) for _ in range(m)]
    x = _rand(rng, 4, 12)
    merged, dims = _check_case(_ffnn, weights, [{"x": x + i} for i in range(m)])
    # fc1 -> bmm demands Batch, ln Channel: a reshape is inserted
    assert [op.op_type for op in merged.ops.values()].count("merge_reshape") == 2
    assert dims["fc1"] is TG.MergeDim.BATCH and dims["ln"] is TG.MergeDim.CHANNEL


@pytest.mark.parametrize("m", [2, 3])
def test_cnn_merge_exact(m):
    rng = np.random.default_rng(10 + m)
    weights = [_cnn_weights(rng) for _ in range(m)]
    img = _rand(rng, 2, 8, 8, 3)
    merged, _ = _check_case(_cnn, weights, [{"img": img * (i + 1)} for i in range(m)],
                            tol=dict(rtol=2e-4, atol=2e-4))
    assert merged.ops["conv1"].attrs["groups"] == m


def test_grouped_ops_compose():
    """4 grouped convs of 2 groups each merge into 8 groups."""
    rng = np.random.default_rng(2)
    m = 4
    weights = [{"gconv": {"w": _rand(rng, 3, 3, 4, 8)}} for _ in range(m)]
    x = _rand(rng, 2, 6, 6, 8)
    merged, _ = _check_case(_grouped, weights, [{"x": x + i} for i in range(m)])
    assert merged.ops["gconv"].attrs["groups"] == 8


def test_merge_rejects_different_architectures():
    from repro_torch.core import merge as M

    with pytest.raises(ValueError):
        M.stack_instances([{"a": torch.zeros(2, 3)}, {"b": torch.zeros(2, 3)}])


def test_dontcare_majority_rule():
    rng = np.random.default_rng(3)

    def weights():
        return {"fc": {"w": _rand(rng, 6, 8)},
                "ln1": {"scale": np.ones(8, np.float32), "bias": np.zeros(8, np.float32)},
                "ln2": {"scale": 2 * np.ones(8, np.float32), "bias": np.ones(8, np.float32)}}

    x = _rand(rng, 4, 6)
    _, dims = _check_case(_majority, [weights(), weights()], [{"x": x + i} for i in range(2)])
    assert dims["sum"] is TG.MergeDim.CHANNEL


def test_entry_points_need_a_device():
    """Without a card and without device='cpu' the entry points raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g = _ffnn(TG.Graph())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.merge_graph(g, [_ffnn_weights(np.random.default_rng(0))])
