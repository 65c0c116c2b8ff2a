"""Op-graph IR and the paper's Algorithm 1, end-to-end DNN merging (port
of ``repro.core.graph``).

A breadth-first walk over a DNN op graph that

  1. merges each op with its M per-instance weight sets into the op's
     input-weight-local counterpart (matmul -> batch matmul, conv ->
     grouped conv, layer norm -> group norm, ...),
  2. tracks the concat dimension each merged op requires (Batch /
     Channel / DontCare),
  3. inserts reshape + transpose fix-ups on edges whose producer and
     consumer disagree (Alg. 1 lines 29-36), and
  4. resolves DontCare ops to the majority dim of their parents (lines
     23-27).

:func:`execute` runs the original and the merged graphs on the port's
``core.fused_ops`` (plain PyTorch ops, as the reference runs plain jnp
ops: no kernel of its own), so the merge can be held to be exact.

Weights and inputs may be numpy arrays or tensors; :func:`merge_graph`,
:func:`execute` and :func:`execute_merged` put them on ``device`` (the
CUDA device unless the caller names another, as every entry point of
the port does).  Activations are NHWC and convolution weights HWIO, the
reference's layouts.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import Counter, deque
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.api import resolve_device
from repro_torch.core import fused_ops


class MergeDim(enum.Enum):
    BATCH = "Batch"
    CHANNEL = "Channel"
    DONTCARE = "DontCare"


# Concat dim demanded by each (merged) op type: Alg. 1 lines 12-16.
_REQUIRED_DIM: dict[str, MergeDim] = {
    "matmul": MergeDim.BATCH,
    "bmm": MergeDim.BATCH,
    "flatten": MergeDim.BATCH,
    "conv2d": MergeDim.CHANNEL,
    "layernorm": MergeDim.CHANNEL,
    "groupnorm": MergeDim.CHANNEL,
    "batchnorm": MergeDim.CHANNEL,
}
# everything else (relu/gelu/tanh/add/mul/maxpool2d/global_avgpool/input)
# is DontCare.


@dataclasses.dataclass
class OpNode:
    name: str
    op_type: str
    inputs: list[str] = dataclasses.field(default_factory=list)
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Graph:
    """A DAG of named ops.  ``ops`` is insertion-ordered; edges are implied
    by ``OpNode.inputs``.  Ops of type ``input`` are graph inputs."""

    ops: dict[str, OpNode] = dataclasses.field(default_factory=dict)
    outputs: list[str] = dataclasses.field(default_factory=list)

    def add(self, name: str, op_type: str, inputs: list[str] | None = None, **attrs) -> str:
        assert name not in self.ops, f"duplicate op {name}"
        self.ops[name] = OpNode(name, op_type, list(inputs or []), attrs)
        return name

    def consumers(self, name: str) -> list[OpNode]:
        return [op for op in self.ops.values() if name in op.inputs]


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device`` (dtype kept)."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return torch.as_tensor(a).to(device)


def _weights_on(weights: dict, device: torch.device) -> dict:
    return {op: {k: _tensor(v, device) for k, v in w.items()} for op, w in weights.items()}


# ---------------------------------------------------------------------------
# Merge() for a single op: paper section 3.1
# ---------------------------------------------------------------------------


def _merge_op(op: OpNode, weights: list[dict[str, torch.Tensor]] | None,
              num_instances: int) -> tuple[OpNode, dict[str, torch.Tensor] | None, MergeDim]:
    """Merge one op with its M per-instance weight dicts.  Returns (merged
    op node, merged weights, required concat dim)."""
    m = num_instances
    t = op.op_type
    dim = _REQUIRED_DIM.get(t, MergeDim.DONTCARE)
    attrs = dict(op.attrs)

    if t == "matmul":
        # matmul -> batch matmul; weights stacked along a new leading axis
        merged = {"w": torch.stack([wi["w"] for wi in weights])}
        if "b" in weights[0]:
            merged["b"] = torch.stack([wi["b"] for wi in weights])
        return OpNode(op.name, "bmm", list(op.inputs), {"num_groups": m}), merged, dim
    if t == "bmm":
        # already input-weight local: stack the group axes -> M*G groups
        g = op.attrs.get("num_groups", weights[0]["w"].shape[0])
        merged = {"w": torch.cat([wi["w"] for wi in weights], dim=0)}
        if "b" in weights[0]:
            merged["b"] = torch.cat([wi["b"] for wi in weights], dim=0)
        attrs["num_groups"] = m * g
        return OpNode(op.name, "bmm", list(op.inputs), attrs), merged, dim
    if t == "conv2d":
        # conv (groups=g) -> grouped conv (groups = M*g); Cout concat
        g = op.attrs.get("groups", 1)
        merged = {"w": torch.cat([wi["w"] for wi in weights], dim=-1)}
        if "b" in weights[0]:
            merged["b"] = torch.cat([wi["b"] for wi in weights], dim=-1)
        attrs["groups"] = m * g
        return OpNode(op.name, "conv2d", list(op.inputs), attrs), merged, dim
    if t in ("layernorm", "groupnorm"):
        # layer norm -> group norm (G = M * previous G); channel concat
        g = op.attrs.get("num_groups", 1) if t == "groupnorm" else 1
        merged = {k: torch.cat([wi[k] for wi in weights], dim=-1) for k in ("scale", "bias")}
        attrs = {"num_groups": m * g, "eps": op.attrs.get("eps", 1e-5)}
        return OpNode(op.name, "groupnorm", list(op.inputs), attrs), merged, dim
    if t == "batchnorm":
        merged = {k: torch.cat([wi[k] for wi in weights], dim=-1)
                  for k in ("mean", "var", "scale", "bias")}
        return OpNode(op.name, "batchnorm", list(op.inputs), attrs), merged, dim
    # non-trainable ops merge as they are (section 3.1)
    return OpNode(op.name, t, list(op.inputs), attrs), None, dim


# ---------------------------------------------------------------------------
# Algorithm 1: DNN merging
# ---------------------------------------------------------------------------


def merge_graph(graph: Graph, weights: list[dict[str, dict[str, Any]]], *, device=None
                ) -> tuple[Graph, dict[str, dict[str, torch.Tensor]], dict[str, MergeDim]]:
    """Merge M instances of ``graph`` (same architecture, different
    weights) into one merged graph.  ``weights[m][op_name]`` holds
    instance m's params for ``op_name`` (numpy arrays or tensors).

    Returns (merged graph, merged weights on ``device``, concat dim per
    op); the dim map is what :func:`execute_merged` uses to split merged
    outputs back into per-instance results."""
    dev = resolve_device(device)
    weights = [_weights_on(w, dev) for w in weights]
    m = len(weights)
    merged = Graph(outputs=list(graph.outputs))
    merged_weights: dict[str, dict[str, torch.Tensor]] = {}
    dims: dict[str, MergeDim] = {}

    # BFS from the roots (Alg. 1 lines 5-6), Kahn-style: an op is visited
    # only after all its parents, whose dims it reads
    indeg = {name: len(op.inputs) for name, op in graph.ops.items()}
    q: deque[str] = deque(name for name, d in indeg.items() if d == 0)
    visited: set[str] = set()
    n_reshapes = 0

    while q:
        name = q.popleft()
        if name in visited:
            continue
        visited.add(name)
        op = graph.ops[name]

        per_instance = [w.get(name, {}) for w in weights]
        has_w = any(per_instance)
        m_op, m_w, d_i = _merge_op(op, per_instance if has_w else None, m)
        if m_w is not None:
            merged_weights[name] = m_w

        # DontCare ops take the majority dim of their parents (lines 23-27)
        if d_i is MergeDim.DONTCARE:
            parent_dims = [dims[p] for p in op.inputs if dims.get(p) is not None]
            parent_dims = [d for d in parent_dims if d is not MergeDim.DONTCARE]
            if parent_dims:
                d_i = Counter(parent_dims).most_common(1)[0][0]
            elif op.op_type == "input":
                d_i = MergeDim.BATCH  # root inputs default to batch concat
        dims[name] = d_i

        # reshape fix-ups on mismatched edges (lines 29-36)
        new_inputs = []
        for parent in m_op.inputs:
            d_j = dims[parent]
            if d_i is not MergeDim.DONTCARE and d_j is not MergeDim.DONTCARE and d_j != d_i:
                r = f"_reshape{n_reshapes}_{parent}_to_{name}"
                n_reshapes += 1
                merged.add(r, "merge_reshape", [parent], from_dim=d_j.value,
                           to_dim=d_i.value, num_instances=m)
                dims[r] = d_i
                new_inputs.append(r)
            else:
                new_inputs.append(parent)
        m_op.inputs = new_inputs
        merged.ops[name] = m_op

        for child in graph.consumers(name):
            indeg[child.name] -= 1
            if indeg[child.name] == 0 and child.name not in visited:
                q.append(child.name)

    assert len(visited) == len(graph.ops), "graph has a cycle or dangling op"
    return merged, merged_weights, dims


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------


def _run_op(op: OpNode, args: list[torch.Tensor], w: dict[str, torch.Tensor] | None
            ) -> torch.Tensor:
    t, a = op.op_type, op.attrs
    if t == "matmul":
        y = args[0] @ w["w"]
        return y + w["b"] if "b" in w else y
    if t == "bmm":
        return fused_ops.batch_matmul_concat(args[0], w["w"], w.get("b"))
    if t == "conv2d":
        y = fused_ops.grouped_conv2d(args[0], w["w"], groups=a.get("groups", 1),
                                     stride=a.get("stride", 1),
                                     padding=a.get("padding", "SAME"))
        return y + w["b"] if "b" in w else y
    if t == "layernorm":
        return fused_ops.group_norm(args[0], w["scale"], w["bias"], num_groups=1,
                                    eps=a.get("eps", 1e-5))
    if t == "groupnorm":
        return fused_ops.group_norm(args[0], w["scale"], w["bias"],
                                    num_groups=a.get("num_groups", 1), eps=a.get("eps", 1e-5))
    if t == "batchnorm":
        return fused_ops.merged_batch_norm(args[0], w["mean"], w["var"], w["scale"],
                                           w["bias"], eps=a.get("eps", 1e-5))
    if t == "merge_reshape":
        m = a["num_instances"]
        if a["from_dim"] == "Batch":
            return fused_ops.batch_to_channel(args[0], m)
        return fused_ops.channel_to_batch(args[0], m)
    if t == "relu":
        return torch.relu(args[0])
    if t == "gelu":
        return F.gelu(args[0], approximate="tanh")   # jax.nn.gelu's default
    if t == "tanh":
        return torch.tanh(args[0])
    if t == "add":
        return args[0] + args[1]
    if t == "mul":
        return args[0] * args[1]
    if t == "maxpool2d":
        k = a.get("kernel", 2)
        y = fused_ops.max_pool_same(args[0].permute(0, 3, 1, 2), k, a.get("stride", k))
        return y.permute(0, 2, 3, 1)
    if t == "global_avgpool":
        return args[0].mean(dim=(1, 2))
    if t == "flatten":
        return args[0].reshape(args[0].shape[0], -1)
    raise NotImplementedError(f"op type {t}")


def execute(graph: Graph, inputs: dict[str, Any], weights: dict[str, dict[str, Any]], *,
            device=None) -> dict[str, torch.Tensor]:
    """Run ``graph`` on ``device``; returns {output name: value}."""
    dev = resolve_device(device)
    weights = _weights_on(weights, dev)
    values: dict[str, torch.Tensor] = {}
    indeg = {n: len(op.inputs) for n, op in graph.ops.items()}
    q = deque(n for n, d in indeg.items() if d == 0)
    while q:
        name = q.popleft()
        op = graph.ops[name]
        if op.op_type == "input":
            values[name] = _tensor(inputs[name], dev)
        else:
            values[name] = _run_op(op, [values[p] for p in op.inputs], weights.get(name))
        for child in graph.consumers(name):
            indeg[child.name] -= 1
            if indeg[child.name] == 0:
                q.append(child.name)
    return {o: values[o] for o in graph.outputs}


def execute_merged(merged: Graph, merged_weights: dict[str, dict[str, Any]],
                   dims: dict[str, MergeDim], per_instance_inputs: list[dict[str, Any]], *,
                   device=None) -> list[dict[str, torch.Tensor]]:
    """Concatenate per-instance inputs along each input node's concat dim,
    run the merged graph once, and split the outputs back per instance."""
    dev = resolve_device(device)
    m = len(per_instance_inputs)
    inputs: dict[str, torch.Tensor] = {}
    for name, op in merged.ops.items():
        if op.op_type != "input":
            continue
        xs = [_tensor(pi[name], dev) for pi in per_instance_inputs]
        inputs[name] = torch.cat(xs, dim=-1 if dims[name] is MergeDim.CHANNEL else 0)
    outs = execute(merged, inputs, merged_weights, device=dev)
    result: list[dict[str, torch.Tensor]] = [{} for _ in range(m)]
    for oname, val in outs.items():
        axis = -1 if dims[oname] is MergeDim.CHANNEL else 0
        for i, part in enumerate(torch.chunk(val, m, dim=axis)):
            result[i][oname] = part
    return result
