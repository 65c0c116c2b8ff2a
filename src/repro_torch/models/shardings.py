"""Which leaf splits along which dim on a (data=D, model=T) serving mesh,
and the per-rank slicing of the params (port of
``repro.launch.shardings``: ``serve_rules``).

The data axis (every family): ``serve_rules`` maps both ``instances``
and ``batch`` to "data", and ``Rules.spec`` gives the axis to the first
of the two that it divides (:func:`data_split`).  Under "instances" data
rank d holds the contiguous instance rows [d M/D, (d+1) M/D) of the
params and the grid; under "batch" it holds every instance and the
slots [d B/D, (d+1) B/D); where neither divides, every data rank holds
the whole grid.  The data slice is taken first (:func:`data_params`),
then the model slice below.

The model axis, for the dense, moe, ssm, hybrid and vlm families (audio
serves on the data axis only):

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

vlm (internvl2): the backbone takes dense's rules (48 / 8 heads split
"kv" up to 8 ranks, d_ff 16384; V 92553 is odd, so the head stays whole)
and the projector stays whole on every rank.  :func:`vlm_cut` applies
them to one drawn layer, as :func:`moe_cut` does for moe.

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

MoE (olmoe, qwen3-moe; the reference's ``serve_rules`` with
``"experts": "model"``): four parts, each decided apart, and a part that
does not divide stays whole on every rank:

* the attention as dense's (``LAYER_SPLIT_DIM``'s ``wq``/``wk``/``wv``/
  ``wo``/``b*``) where ``tp_head_plan(H, KVH, T)`` is "kv", else whole;
* the experts ``we_gate``/``we_up``/``we_down`` (L, M, E, ...) on E, in
  contiguous windows of E/T experts, where E % T == 0;
* the router whole: every rank routes every token, as the reference's
  expert-parallel ranks do;
* ``lm_head`` by vocab where V divides; the embedding and the norms
  whole.

:func:`moe_cut` applies the same rules to one drawn layer of a leaf, so
a rank can draw its shard layer by layer without holding the whole.

xLSTM (xlstm-1.3b; :func:`xlstm_split`): three parts, each decided apart,
and a part that does not divide stays whole on every rank:

* the mLSTM and sLSTM layers by heads where ``num_heads % T == 0``
  (xlstm-1.3b: 4 heads, so T in {2, 4}).  An mLSTM rank holds its heads'
  columns of both halves of ``w_up`` (its ``xi`` channels, then its ``z``
  channels: two column blocks, concatenated), its channels of ``conv_w``,
  ``conv_b`` and ``out_norm``, its heads of ``wq``/``wk``/``wv``, and its
  channel rows of ``w_gates`` and ``w_down``; ``b_gates`` and ``norm``
  stay whole.  The gate pre-activations are row-parallel, so the layer
  ends in two sums: the gates (added to ``b_gates`` once, after the sum),
  then the down-projection.  An sLSTM rank holds, for each of the four
  gates (z, i, f, o), its heads' columns of ``w_in`` and ``b_in``
  (gathered into a contiguous (M, D, 4 D/T)), its heads of ``r`` and its
  channels of ``out_norm``; ``norm`` and ``ffn_norm`` stay whole.  The
  cell runs on the rank's heads and its (M, B, D/T) state, and the
  head-normed outputs are gathered over the ranks before the residual;
* the sLSTM FFN by ``slstm_ff % T`` (2688 for xlstm-1.3b):
  ``w_ff_gate``/``w_ff_up`` columns, ``w_ff_down`` rows, one sum;
* ``lm_head`` by vocab where V divides (50304 over 2 and 4); the
  embedding and ``final_norm`` whole.

The reference's rules put these leaves on "model" ("heads", "mlp") and
let GSPMD add the sums; its split of "mlp" over ``w_up`` is not a
per-head split, the port's is.

Every slice is a contiguous copy, so ``LaneGroups`` and the kernels take
a shard as they take a whole model.  The rules are decided here and
nowhere else: :func:`layer_group`, :func:`vocab_group`,
:func:`hybrid_split` and :func:`xlstm_split` hand the model the
``TensorParallel`` handle where a split applies and ``None`` where the rank holds the whole, and the
sharded kernel wrappers take that handle as it comes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.decode_attn import rank_kv_heads
from repro_torch.kernels.decode_layer import tp_head_plan
from repro_torch.models.common import MergedParams, instance_rows

# dense layer leaf -> the dim of its (L, M, ...) tensor split over the ranks
LAYER_SPLIT_DIM = {
    "wq": 3, "bq": 2, "wo": 2,                     # query heads
    "wk": 3, "wv": 3, "bk": 2, "bv": 2,            # kv heads
    "w_gate": 3, "w_up": 3, "w_down": 2,           # d_ff
}
LM_HEAD_SPLIT_DIM = 2                              # (M, D, V): vocab
# moe expert leaf (L, M, E, ...) -> its experts dim
EXPERT_SPLIT_DIM = {"we_gate": 2, "we_up": 2, "we_down": 2}
ATTN_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def data_split(m: int, b: int, d: int) -> str | None:
    """Which grid dim of an (M, B) grid the data axis of size ``d``
    splits: "instances", "batch" or None (replicated), as
    ``serve_rules(mesh).spec(("instances", "batch"), (M, B))`` decides:
    a dim takes the axis where it divides, and the axis is used once."""
    if m % d == 0:
        return "instances"
    return "batch" if b % d == 0 else None


class DataRows(NamedTuple):
    """A data rank's block of the (M, B) grid: the split, its instance
    rows [m0, m0 + m) and its slots [b0, b0 + b)."""
    split: str | None
    m0: int
    m: int
    b0: int
    b: int

    def owns(self, mi: int, bi: int) -> bool:
        return self.m0 <= mi < self.m0 + self.m and self.b0 <= bi < self.b0 + self.b

    def block(self, grid):
        """The rank's block of an (M, B, ...) array."""
        return grid[self.m0:self.m0 + self.m, self.b0:self.b0 + self.b]

    @property
    def gather_dim(self) -> int:
        """The grid dim the data ranks' blocks concatenate along."""
        return 0 if self.split == "instances" else 1


def data_rows(m: int, b: int, data) -> DataRows:
    """The block of data rank ``data.rank`` of ``data.size`` (``data``
    None: the whole grid)."""
    d, i = (1, 0) if data is None else (data.size, data.rank)
    split = data_split(m, b, d)
    if d > 1 and split == "instances":
        return DataRows(split, i * (m // d), m // d, 0, b)
    if d > 1 and split == "batch":
        return DataRows(split, 0, m, i * (b // d), b // d)
    return DataRows(split, 0, m, 0, b)


def data_params(params, rows: DataRows, first: int = 0) -> MergedParams:
    """The data slice of merged params whose instances are the grid's
    [first, first + n): the rank's instance rows, copied, or ``params``
    itself where they are exactly those rows."""
    n = params["embed"].shape[0]
    lo = rows.m0 - first
    if lo < 0 or lo + rows.m > n:
        raise ValueError(f"params hold instances [{first}, {first + n}); this rank needs "
                         f"[{rows.m0}, {rows.m0 + rows.m})")
    return params if (lo, rows.m) == (0, n) else instance_rows(params, lo, rows.m)


def layers_split(cfg, n: int) -> bool:
    """Whether the dense layers' heads and FFN split over ``n`` ranks."""
    return tp_head_plan(cfg.num_heads, cfg.num_kv_heads, n) == "kv" and cfg.d_ff % n == 0


def vocab_split(cfg, n: int) -> bool:
    """Whether the unembedding splits by vocab over ``n`` ranks (dense)."""
    return n > 1 and cfg.vocab_size % n == 0


def attn_split(cfg, n: int) -> bool:
    """Whether a moe model's attention heads split over ``n`` ranks."""
    return head_plan(cfg, n) == "kv"


def expert_split(cfg, n: int) -> bool:
    """Whether a moe model's experts split into windows over ``n`` ranks."""
    return n > 1 and cfg.num_experts % n == 0


def attn_group(cfg, tp):
    """``tp`` where a moe model's attention splits, else ``None``."""
    return tp if tp is not None and attn_split(cfg, tp.size) else None


def expert_group(cfg, tp):
    """``tp`` where a moe model's experts split, else ``None``."""
    return tp if tp is not None and expert_split(cfg, tp.size) else None


def moe_layer_dims(cfg, n: int) -> dict:
    """moe layer leaf -> the dim of its (L, M, ...) tensor split over
    ``n`` ranks (the leaves that stay whole are absent)."""
    dims = {}
    if attn_split(cfg, n):
        dims.update({k: LAYER_SPLIT_DIM[k] for k in ATTN_LEAVES})
    if expert_split(cfg, n):
        dims.update(EXPERT_SPLIT_DIM)
    return dims


def moe_cut(cfg, rank: int, n: int):
    """Rank ``rank``'s slice of a moe leaf as it is drawn: ``cut(name,
    t, layer)``, ``t`` a top-level leaf (``layer`` False) or one layer of
    a layer leaf, its L axis dropped (``layer`` True).  The shard of
    :func:`shard_params`, a layer at a time."""
    dims = moe_layer_dims(cfg, n)

    def cut(name: str, t: torch.Tensor, layer: bool) -> torch.Tensor:
        if layer:
            return shard(t, dims[name] - 1, rank, n) if name in dims else t
        if name == "lm_head" and vocab_split(cfg, n):
            return shard(t, LM_HEAD_SPLIT_DIM, rank, n)
        return t
    return cut


def vlm_cut(cfg, rank: int, n: int):
    """Rank ``rank``'s slice of a vlm leaf as it is drawn (``cut(name, t,
    layer)`` as in :func:`moe_cut`): dense's layer split where
    :func:`layers_split`, ``lm_head`` by vocab where :func:`vocab_split`;
    everything else whole.  The shard of :func:`shard_params`, a layer at
    a time."""
    split = layers_split(cfg, n)

    def cut(name: str, t: torch.Tensor, layer: bool) -> torch.Tensor:
        if layer:
            return shard(t, LAYER_SPLIT_DIM[name] - 1, rank, n) if (
                split and name in LAYER_SPLIT_DIM) else t
        if name == "lm_head" and vocab_split(cfg, n):
            return shard(t, LM_HEAD_SPLIT_DIM, rank, n)
        return t
    return cut


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


def xlstm_heads_split(cfg, n: int) -> bool:
    """Whether an xLSTM model's mLSTM and sLSTM heads split over ``n``
    ranks."""
    return n > 1 and cfg.num_heads % n == 0


def slstm_ffn_split(cfg, n: int) -> bool:
    """Whether the sLSTM blocks' gated FFN splits over ``n`` ranks."""
    from repro_torch.models.ssm import slstm_ff   # ssm imports this module
    return n > 1 and slstm_ff(cfg) % n == 0


class XlstmSplit(NamedTuple):
    """An xLSTM rank's layer splits: the handle of each part that splits
    (``None``: held whole) -- the mLSTM and sLSTM heads, the sLSTM FFN
    (the vocab is :func:`vocab_group`'s, as dense's)."""
    heads: object
    ffn: object


def xlstm_split(cfg, tp) -> XlstmSplit:
    """The layer splits of an xLSTM model on the rank of ``tp`` (both
    whole on one device)."""
    n = 1 if tp is None else tp.size
    return XlstmSplit(tp if xlstm_heads_split(cfg, n) else None,
                      tp if slstm_ffn_split(cfg, n) else None)


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
    split = attn_split(cfg, n) if cfg.family == "moe" else layers_split(cfg, n)
    return cfg.num_kv_heads // n if split else cfg.num_kv_heads


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


def head_columns(leaf: torch.Tensor, parts: int, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s 1/n of each of the ``parts`` equal column blocks of
    ``leaf``'s last dim, concatenated (a copy): the rank's heads of every
    gate of a fused gate projection."""
    blocks = leaf.chunk(parts, -1)
    return torch.cat([b.chunk(n, -1)[rank] for b in blocks], -1)


def _xlstm_tree(cfg, tree: dict, rank: int, n: int) -> dict:
    tree = dict(tree)
    heads, ffn = xlstm_heads_split(cfg, n), slstm_ffn_split(cfg, n)
    if heads:
        runs = []
        for run in tree["mlstm_runs"]:
            if run is not None:
                run = dict(run)
                run["w_up"] = head_columns(run["w_up"], 2, rank, n)
                for k, dim in (("conv_w", 3), ("conv_b", 2), ("out_norm", 2), ("wq", 2),
                               ("wk", 2), ("wv", 2), ("w_gates", 2), ("w_down", 2)):
                    run[k] = shard(run[k], dim, rank, n)
            runs.append(run)
        tree["mlstm_runs"] = runs
    blocks = []
    for lay in tree["slstm"]:
        lay = dict(lay)
        if heads:
            lay["w_in"] = head_columns(lay["w_in"], 4, rank, n)
            lay["b_in"] = head_columns(lay["b_in"], 4, rank, n)
            lay["r"] = shard(lay["r"], 2, rank, n)
            lay["out_norm"] = shard(lay["out_norm"], 1, rank, n)
        if ffn:
            for k, dim in (("w_ff_gate", 2), ("w_ff_up", 2), ("w_ff_down", 1)):
                lay[k] = shard(lay[k], dim, rank, n)
        blocks.append(lay)
    tree["slstm"] = blocks
    if vocab_split(cfg, n):
        tree["lm_head"] = shard(tree["lm_head"], LM_HEAD_SPLIT_DIM, rank, n)
    return tree


def refuse_family(cfg) -> None:
    """Raise for a family that has no model axis (audio: ROADMAP Queue 1)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"tensor parallelism is ported for the dense, moe, ssm, hybrid and vlm families, "
            f"not {cfg.family!r}: the audio family's model axis is ROADMAP Queue 1, item 1 "
            f"(its data axis serves)")


def shard_params(cfg, params, rank: int, n: int) -> MergedParams:
    """Rank ``rank``'s shard of a dense, moe, ssm, hybrid or vlm model's
    merged params over ``n`` ranks, on the device ``params`` lie on: split
    leaves sliced, the others (vlm's projector among them) shared with
    ``params``."""
    refuse_family(cfg)
    tree = params.tree()
    if cfg.family == "ssm":
        return MergedParams(_xlstm_tree(cfg, tree, rank, n))
    if cfg.family == "hybrid":
        tree["layers"] = _hybrid_layers(cfg, tree["layers"], rank, n)
        return MergedParams(tree)
    if cfg.family == "moe":
        dims = moe_layer_dims(cfg, n)
        tree["layers"] = {k: shard(v, dims[k], rank, n) if k in dims else v
                          for k, v in tree["layers"].items()}
        tree["lm_head"] = moe_cut(cfg, rank, n)("lm_head", tree["lm_head"], False)
        return MergedParams(tree)
    if layers_split(cfg, n):
        tree["layers"] = {k: shard(v, LAYER_SPLIT_DIM[k], rank, n) if k in LAYER_SPLIT_DIM
                          else v for k, v in tree["layers"].items()}
    if vocab_split(cfg, n) and not cfg.tie_embeddings:
        tree["lm_head"] = shard(tree["lm_head"], LM_HEAD_SPLIT_DIM, rank, n)
    return MergedParams(tree)
