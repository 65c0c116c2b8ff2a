"""Which leaf splits along which dim under tensor parallelism, and the
per-rank slicing of the params (port of ``repro.launch.shardings``: the
"model" axis of ``serve_rules``), for the dense and hybrid families.

Dense, Megatron style over the port's ``(L, M, ...)`` layer leaves:

* ``wq`` columns and ``wo`` rows by query heads, ``wk``/``wv`` columns by
  kv heads, ``bq`` by query heads and ``bk``/``bv`` by kv heads.  Query
  heads are laid out kvh-major, so rank r's contiguous block of H/T query
  heads is exactly the group of its KVH/T kv heads;
* ``w_gate``/``w_up`` columns and ``w_down`` rows by d_ff;
* ``lm_head`` columns by vocab (a tied ``embed`` is sliced by its V rows
  where the head is formed: the lookup table stays whole);
* the embedding table and the norm scales replicated.

Where ``tp_head_plan`` is not "kv" or d_ff does not divide over the
ranks, the dense layers stay whole on every rank (the reference's
"data-local" branch of ``decode_layer_sharded``); the vocab splits only
when V divides.

Hybrid (hymba): three splits, each decided apart by its own rule, and a
part that does not divide stays whole on every rank (the same
data-local rule):

* the attention heads by ``tp_head_plan(H, KVH, T)``.  Under "kv" or
  "expand" ``wq`` columns and ``wo`` rows split by the rank's H/T query
  heads, and ``wk``/``wv`` columns are the kv heads those q heads read
  (``decode_attn.rank_kv_heads``): the rank's KVH/T under "kv", the one
  or few it shares with its neighbours under "expand", computed on every
  rank that reads them.  None keeps the attention whole;
* the FFN by ``d_ff % T``: ``w_gate``/``w_up`` columns, ``w_down`` rows;
* the mamba branch by ``ssm_heads % T``, in channels of whole SSM heads.
  The ``xi`` half of ``w_ssm_in``, the conv, ``w_bc``, ``w_dt``,
  ``b_dt`` and ``a_log`` stay whole on every rank, because B, C and dt
  feed every SSM head: each rank computes them in full and needs no sum
  for them.  The ``z`` half of ``w_ssm_in``, ``d_skip``, the state ``h``
  (M, B, Di, N) and the rows of ``w_ssm_out`` split, so the branch ends
  in one sum.  The reference's rules put these leaves on "model" ("mlp")
  and let GSPMD add the sums it needs; the port trades that for three
  small projections computed on every rank.
* the embedding, the meta tokens, the norms and ``lm_head`` whole: V of
  hymba is odd, and the logits stay whole on every rank.

Every slice is a contiguous copy, so ``LaneGroups`` and the kernels take
a shard as they take a whole model.  The rules are decided here and
nowhere else: :func:`layer_group`, :func:`vocab_group` and
:func:`hybrid_split` hand the model the ``TensorParallel`` handle where a
split applies and ``None`` where the rank holds the whole, and the
sharded kernel wrappers take that handle as it comes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.decode_attn import rank_kv_heads
from repro_torch.kernels.decode_layer import tp_head_plan
from repro_torch.models.common import MergedParams

# dense layer leaf -> the dim of its (L, M, ...) tensor split over the ranks
LAYER_SPLIT_DIM = {
    "wq": 3, "bq": 2, "wo": 2,                     # query heads
    "wk": 3, "wv": 3, "bk": 2, "bv": 2,            # kv heads
    "w_gate": 3, "w_up": 3, "w_down": 2,           # d_ff
}
LM_HEAD_SPLIT_DIM = 2                              # (M, D, V): vocab
FAMILIES = ("dense", "hybrid")


def layers_split(cfg, n: int) -> bool:
    """Whether the dense layers' heads and FFN split over ``n`` ranks."""
    return tp_head_plan(cfg.num_heads, cfg.num_kv_heads, n) == "kv" and cfg.d_ff % n == 0


def vocab_split(cfg, n: int) -> bool:
    """Whether the unembedding splits by vocab over ``n`` ranks (dense)."""
    return n > 1 and cfg.vocab_size % n == 0


def layer_group(cfg, tp):
    """``tp`` where the dense layers split over its ranks, else ``None``
    (one device, or the layers held whole on every rank)."""
    return tp if tp is not None and layers_split(cfg, tp.size) else None


def vocab_group(cfg, tp):
    """``tp`` where the vocab splits over its ranks, else ``None``."""
    return tp if tp is not None and vocab_split(cfg, tp.size) else None


def head_plan(cfg, n: int) -> str | None:
    return tp_head_plan(cfg.num_heads, cfg.num_kv_heads, n)


def ffn_split(cfg, n: int) -> bool:
    return n > 1 and cfg.d_ff % n == 0


def ssm_split(cfg, n: int) -> bool:
    from repro_torch.models.hybrid import ssm_heads   # hybrid imports this module
    return n > 1 and ssm_heads(cfg) % n == 0


class HybridSplit(NamedTuple):
    """A hybrid rank's three splits: the handle of each part that splits
    (``None``: held whole), the head plan, and the kv heads [kv_lo,
    kv_hi) its query heads read, with ``kv_index`` as
    ``rank_kv_heads`` gives it (None unless they straddle unevenly)."""
    heads: object
    ffn: object
    ssm: object
    plan: str | None
    kv_lo: int
    kv_hi: int
    kv_index: list[int] | None


def hybrid_split(cfg, tp) -> HybridSplit:
    """The splits of a hybrid model on the rank of ``tp`` (all whole on
    one device)."""
    n = 1 if tp is None else tp.size
    plan = head_plan(cfg, n)
    lo, hi, index = (rank_kv_heads(cfg.num_heads, cfg.num_kv_heads, n, tp.rank) if plan
                     else (0, cfg.num_kv_heads, None))
    return HybridSplit(tp if plan else None, tp if ffn_split(cfg, n) else None,
                       tp if ssm_split(cfg, n) else None, plan, lo, hi, index)


def sum_over(group, part: torch.Tensor) -> torch.Tensor:
    """The sum of the ranks' partials over ``group``; ``part`` itself
    where the part is held whole (``group`` None)."""
    return part if group is None else group.all_reduce_sum(part)


def local_kv_heads(cfg, n: int, rank: int = 0) -> int:
    """KV heads of rank ``rank``'s cache shard."""
    if cfg.family == "hybrid":
        if not head_plan(cfg, n):
            return cfg.num_kv_heads
        lo, hi, _ = rank_kv_heads(cfg.num_heads, cfg.num_kv_heads, n, rank)
        return hi - lo
    return cfg.num_kv_heads // n if layers_split(cfg, n) else cfg.num_kv_heads


def shard(leaf: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous 1/n of ``leaf`` along ``dim``, a copy."""
    return leaf.chunk(n, dim)[rank].contiguous()


def _hybrid_layers(cfg, lay: dict, rank: int, n: int) -> dict:
    from repro_torch.models.hybrid import d_inner   # hybrid imports this module

    lay = dict(lay)
    if head_plan(cfg, n):
        lo, hi, _ = rank_kv_heads(cfg.num_heads, cfg.num_kv_heads, n, rank)
        hd = cfg.head_dim
        lay["wq"], lay["wo"] = shard(lay["wq"], 3, rank, n), shard(lay["wo"], 2, rank, n)
        for k in ("wk", "wv"):
            lay[k] = lay[k].narrow(3, lo * hd, (hi - lo) * hd).contiguous()
    if ffn_split(cfg, n):
        for k, dim in (("w_gate", 3), ("w_up", 3), ("w_down", 2)):
            lay[k] = shard(lay[k], dim, rank, n)
    if ssm_split(cfg, n):
        xi, z = lay["w_ssm_in"].split(d_inner(cfg), dim=3)
        lay["w_ssm_in"] = torch.cat([xi, shard(z, 3, rank, n)], 3)
        lay["d_skip"] = shard(lay["d_skip"], 2, rank, n)
        lay["w_ssm_out"] = shard(lay["w_ssm_out"], 2, rank, n)
    return lay


def shard_params(cfg, params, rank: int, n: int) -> MergedParams:
    """Rank ``rank``'s shard of a dense or hybrid model's merged params
    over ``n`` ranks, on the device ``params`` lie on: split leaves
    sliced, the others shared with ``params``."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"tensor parallelism is ported for the dense and hybrid families, "
            f"not {cfg.family!r}")
    tree = params.tree()
    if cfg.family == "hybrid":
        tree["layers"] = _hybrid_layers(cfg, tree["layers"], rank, n)
        return MergedParams(tree)
    if layers_split(cfg, n):
        tree["layers"] = {k: shard(v, LAYER_SPLIT_DIM[k], rank, n) if k in LAYER_SPLIT_DIM
                          else v for k, v in tree["layers"].items()}
    if vocab_split(cfg, n) and not cfg.tie_embeddings:
        tree["lm_head"] = shard(tree["lm_head"], LM_HEAD_SPLIT_DIM, rank, n)
    return MergedParams(tree)
