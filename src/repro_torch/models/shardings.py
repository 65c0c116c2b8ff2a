"""Which leaf splits along which dim under tensor parallelism, and the
per-rank slicing of the dense family's params (port of
``repro.launch.shardings``: the "model" axis of ``serve_rules``).

Megatron style over the port's ``(L, M, ...)`` layer leaves:

* ``wq`` columns and ``wo`` rows by query heads, ``wk``/``wv`` columns by
  kv heads, ``bq`` by query heads and ``bk``/``bv`` by kv heads.  Query
  heads are laid out kvh-major, so rank r's contiguous block of H/T query
  heads is exactly the group of its KVH/T kv heads;
* ``w_gate``/``w_up`` columns and ``w_down`` rows by d_ff;
* ``lm_head`` columns by vocab (a tied ``embed`` is sliced by its V rows
  where the head is formed: the lookup table stays whole);
* the embedding table and the norm scales replicated.

Every slice is a contiguous copy, so ``LaneGroups`` and the kernels take
a shard as they take a whole model.  Where ``tp_head_plan`` is not "kv" or
d_ff does not divide over the ranks, the layers stay whole on every rank
(the reference's "data-local" branch of ``decode_layer_sharded``); the
vocab splits only when V divides.

These two rules are decided here and nowhere else: :func:`layer_group`
and :func:`vocab_group` hand the model the ``TensorParallel`` handle
where a split applies and ``None`` where the rank holds the whole, and
the sharded kernel wrappers take that handle as it comes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_layer import tp_head_plan
from repro_torch.models.common import MergedParams

# layer leaf -> the dim of its (L, M, ...) tensor split over the ranks
LAYER_SPLIT_DIM = {
    "wq": 3, "bq": 2, "wo": 2,                     # query heads
    "wk": 3, "wv": 3, "bk": 2, "bv": 2,            # kv heads
    "w_gate": 3, "w_up": 3, "w_down": 2,           # d_ff
}
LM_HEAD_SPLIT_DIM = 2                              # (M, D, V): vocab


def layers_split(cfg, n: int) -> bool:
    """Whether the layers' heads and FFN split over ``n`` ranks."""
    return tp_head_plan(cfg.num_heads, cfg.num_kv_heads, n) == "kv" and cfg.d_ff % n == 0


def vocab_split(cfg, n: int) -> bool:
    """Whether the unembedding splits by vocab over ``n`` ranks."""
    return n > 1 and cfg.vocab_size % n == 0


def layer_group(cfg, tp):
    """``tp`` where the layers split over its ranks, else ``None`` (one
    device, or the layers held whole on every rank)."""
    return tp if tp is not None and layers_split(cfg, tp.size) else None


def vocab_group(cfg, tp):
    """``tp`` where the vocab splits over its ranks, else ``None``."""
    return tp if tp is not None and vocab_split(cfg, tp.size) else None


def local_kv_heads(cfg, n: int) -> int:
    """KV heads of a rank's cache shard."""
    return cfg.num_kv_heads // n if layers_split(cfg, n) else cfg.num_kv_heads


def shard(leaf: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous 1/n of ``leaf`` along ``dim``, a copy."""
    return leaf.chunk(n, dim)[rank].contiguous()


def shard_params(cfg, params, rank: int, n: int) -> MergedParams:
    """Rank ``rank``'s shard of a dense model's merged params over ``n``
    ranks, on the device ``params`` lie on: split leaves sliced, the
    others shared with ``params``."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"tensor parallelism is ported for the dense family, not {cfg.family!r}")
    tree = params.tree()
    if layers_split(cfg, n):
        tree["layers"] = {k: shard(v, LAYER_SPLIT_DIM[k], rank, n) if k in LAYER_SPLIT_DIM
                          else v for k, v in tree["layers"].items()}
    if vocab_split(cfg, n) and not cfg.tie_embeddings:
        tree["lm_head"] = shard(tree["lm_head"], LM_HEAD_SPLIT_DIM, rank, n)
    return MergedParams(tree)
