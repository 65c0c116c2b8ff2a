"""xLSTM (sLSTM + mLSTM blocks) -- xlstm-1.3b (port of ``repro.models.ssm``).

Layer layout: layer i is an sLSTM block when
``i % cfg.slstm_every == cfg.slstm_offset``; the mLSTM runs between sLSTM
layers are stacked on a leading L axis.  Parameters carry a leading
instances axis M, activations are (M, B, S, D).

Serving: the mLSTM is plain PyTorch, as the reference serves it through
its XLA path: the chunkwise-parallel ``mlstm_sequence`` for a prefill
chunk and the single-step ``mlstm_step`` for decode.  Every sLSTM block
runs its recurrent scan through ``kernels/ops.slstm_cell`` (the Hopper
kernel on CUDA tensors, its plain version on CPU tensors), in each
prefill chunk and each decode step; greedy decode ends in the fused
logits kernel.

Training and a prefill from scratch (``forward``, ``prefill``): every
block runs its whole-sequence form from a zero state, nothing in place;
the mLSTM cell is ``ops.mlstm_chunkwise`` and the sLSTM scan
``ops.slstm_cell``, both under autograd Functions whose backward
differentiates the reference's training math (``mlstm_sequence``,
``slstm_scan``, kept beside their kernels in ``kernels/mlstm_chunk`` and
``kernels/slstm_cell``).

The serving state is updated in place.  ``valid`` (M, B, S) marks the
junk suffix of a padded final prefill chunk: junk steps get neutral gates
in every cell, so the carried state equals the exact-length pass.
``alive`` (M, B) leaves the state of a stopped decode lane untouched.
Norms reduce each row on its own (``layers.rms_norm_rowwise``) and the
mLSTM step's state product is the merged-matmul kernel in f32, so a
lane's decode does not depend on how many instances share the call.

Tensor parallelism (serving): with a ``TensorParallel`` handle ``tp``
the params and states are this rank's shard (``models/shardings.py``:
``xlstm_split`` for the heads and the sLSTM FFN, ``vocab_group`` for the
head, each decided apart).
The blocks read their heads and widths off the leaves they are given.
An mLSTM layer on the rank's heads ends in two sums: the gate
pre-activations (row-parallel over the rank's channels; ``b_gates``
added once after the sum), then the down-projection.  An sLSTM layer runs
the cell on the rank's heads and its (M, B, D/T) state and gathers the
head-normed outputs over the ranks, in rank order, before the residual;
its FFN ends in one sum.  Greedy decode ends in the fused logits kernel
over the rank's vocab slice and a cross-rank combine
(``ops.logits_sample_sharded``).  The whole-sequence forms (``forward``,
``prefill``) run on one device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
# the reference's training math lives beside the kernels it differentiates
from repro_torch.kernels.mlstm_chunk import mlstm_sequence
from repro_torch.kernels.slstm_cell import log_sigmoid, slstm_scan
from repro_torch.models import layers as L
from repro_torch.models import shardings as S
from repro_torch.models.common import (
    Factory, MergedParams, training_params, tree_map, tree_put_slot, tree_take_slot,
)

NEG_INF = -1e30

# leaves the model casts to the activation dtype at every use (storing
# them in cfg.dtype computes the same numbers); the recurrent weights r,
# the norm scales, embed and lm_head stay in param_dtype
ACT_LEAVES = ("w_up", "conv_w", "conv_b", "wq", "wk", "wv", "w_gates", "b_gates",
              "out_norm", "w_down", "w_in", "b_in", "w_ff_gate", "w_ff_up", "w_ff_down")


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# config helpers
# ---------------------------------------------------------------------------


def d_inner(cfg: ModelConfig) -> int:
    return int(cfg.mlstm_proj_factor * cfg.d_model)


def slstm_ff(cfg: ModelConfig) -> int:
    # xLSTM sLSTM blocks use a gated FFN with proj factor 4/3, rounded to 128.
    return max(128, int(round(cfg.d_model * 4 / 3 / 128)) * 128)


def is_slstm_layer(cfg: ModelConfig, i: int) -> bool:
    return cfg.slstm_every > 0 and i % cfg.slstm_every == cfg.slstm_offset


def mlstm_runs(cfg: ModelConfig) -> list[int]:
    """Lengths of the contiguous mLSTM runs between sLSTM layers
    (n_slstm + 1 entries, which may be 0)."""
    runs, cur = [], 0
    for i in range(cfg.num_layers):
        if is_slstm_layer(cfg, i):
            runs.append(cur)
            cur = 0
        else:
            cur += 1
    runs.append(cur)
    return runs


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _mlstm_layer_params(cfg: ModelConfig, f: Factory, n: int) -> dict:
    m, d = cfg.num_instances, cfg.d_model
    di, h = d_inner(cfg), cfg.num_heads
    hd = di // h
    return {
        "norm": f((n, m, d), init="ones"),
        "w_up": f((n, m, d, 2 * di), init="fan_in"),
        "conv_w": f((n, m, cfg.conv_kernel, di), init="fan_in"),
        "conv_b": f((n, m, di), init="zeros"),
        # block-diagonal per-head q/k/v
        "wq": f((n, m, h, hd, hd), init="fan_in"),
        "wk": f((n, m, h, hd, hd), init="fan_in"),
        "wv": f((n, m, h, hd, hd), init="fan_in"),
        "w_gates": f((n, m, di, 2 * h), init="fan_in"),
        "b_gates": f((n, m, 2 * h), init="zeros"),
        "out_norm": f((n, m, di), init="ones"),
        "w_down": f((n, m, di, d), init="fan_in"),
    }


def _slstm_layer_params(cfg: ModelConfig, f: Factory) -> dict:
    m, d, h = cfg.num_instances, cfg.d_model, cfg.num_heads
    hd = d // h
    ff = slstm_ff(cfg)
    return {
        "norm": f((m, d), init="ones"),
        "w_in": f((m, d, 4 * d), init="fan_in"),
        "b_in": f((m, 4 * d), init="zeros"),
        # per-head block-diagonal recurrent weights
        "r": f((m, 4, h, hd, hd), init="fan_in"),
        "out_norm": f((m, d), init="ones"),
        "ffn_norm": f((m, d), init="ones"),
        "w_ff_gate": f((m, d, ff), init="fan_in"),
        "w_ff_up": f((m, d, ff), init="fan_in"),
        "w_ff_down": f((m, ff, d), init="fan_in"),
    }


def build_params(cfg: ModelConfig, f: Factory) -> dict:
    m, d, v = cfg.num_instances, cfg.d_model, cfg.vocab_size
    runs = mlstm_runs(cfg)
    return {
        "embed": f((m, v, d)),
        "mlstm_runs": [_mlstm_layer_params(cfg, f, n) if n else None for n in runs],
        "slstm": [_slstm_layer_params(cfg, f) for _ in range(len(runs) - 1)],
        "final_norm": f((m, d), init="ones"),
        "lm_head": f((m, d, v), init="fan_in"),
    }


def storage_dtypes(cfg: ModelConfig, tree: dict) -> dict:
    """Cast a parameter tree to the port's storage dtypes."""
    act, par = torch_dtype(cfg.dtype), torch_dtype(cfg.param_dtype)

    def conv(x, name=""):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v, name) for v in x]
        return x.to(act if name in ACT_LEAVES else par)

    return conv(tree)


def init(cfg: ModelConfig, generator: torch.Generator | None,
         device: torch.device, *, train: bool = False) -> MergedParams:
    """Random parameters with the reference's distributions, drawn from
    ``generator`` (on ``device``), in the port's storage dtypes; with
    ``train``, the trainable form (``common.training_params``)."""
    f = Factory(generator, torch_dtype(cfg.param_dtype), torch.device(device))
    tree = build_params(cfg, f)
    return training_params(cfg, tree) if train else MergedParams(storage_dtypes(cfg, tree))


# ---------------------------------------------------------------------------
# mLSTM cell: chunkwise-parallel sequence form and single-step form
# ---------------------------------------------------------------------------


def mlstm_step_(state, q, k, v, lf, li, alive=None):
    """Single decode step on ``state`` = (C, n, m), in place.  q, k, v
    (M, B, H, hd); lf, li (M, B, H).  A lane with ``alive`` False keeps
    its state exactly (forget 1, input 0 on zeroed k, v).  Returns h
    (M, B, H, hd) f32."""
    C0, n0, m0 = state
    hd = q.shape[-1]
    mt = torch.maximum(m0 + lf, li)
    fp = torch.exp(lf + m0 - mt)
    ip = torch.exp(li - mt)
    kf, vf = k.float(), v.float()
    if alive is not None:
        live = alive[..., None]
        fp = torch.where(live, fp, torch.ones_like(fp))
        ip = torch.where(live, ip, torch.zeros_like(ip))
        kf = torch.where(live[..., None], kf, torch.zeros_like(kf))
        vf = torch.where(live[..., None], vf, torch.zeros_like(vf))
        mt = torch.where(live, mt, m0)
    # C <- fp C + ip k v^T in place: a scaling pass and a rank-1 GEMM
    C0.mul_(fp[..., None, None])
    C0.view(-1, hd, hd).baddbmm_((ip[..., None] * kf).reshape(-1, hd, 1),
                                 vf.reshape(-1, 1, hd))
    n0.mul_(fp[..., None]).add_(ip[..., None] * kf)
    m0.copy_(mt)
    qf = q.float() / math.sqrt(hd)
    # q C on the merged-matmul kernel, one (1, hd) @ (hd, hd) product per
    # (lane, head) in f32 (its FMA path sums D in one order whatever the
    # count): a batched library product would give a lane other bits at
    # another M
    num = K.fused_matmul(qf.reshape(-1, 1, hd).contiguous(),
                         C0.view(-1, hd, hd)).view(qf.shape)
    den = (qf * n0).sum(-1)
    return num / torch.maximum(den.abs(), torch.exp(-mt))[..., None]


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def _lane_rows(lp: dict, groups: L.LaneGroups | None, matmul: tuple[str, ...]) -> dict:
    """Per-lane rows of the leaves that are not batched matmul weights
    (``groups`` reads those through views)."""
    if groups is None:
        return lp
    return {k: (lp[k] if k in matmul else groups.rows(lp[k], 0)) for k in lp.keys()}


def _causal_conv(x, w, b, conv_state, nvalid=None):
    """Depthwise causal conv over [carried inputs, x].  x (M, B, S, Di);
    w (M, K, Di); conv_state (M, B, K-1, Di) trailing inputs of the
    previous call.  ``nvalid`` (M, B): count of valid leading positions;
    the carried window is then taken at the last valid inputs.  The K
    taps are summed in the activation dtype in the order 0 .. K-1, as
    the reference does."""
    k, s = w.shape[1], x.shape[2]
    ext = torch.cat([conv_state.to(x.dtype), x], dim=2)
    pads = [ext[:, :, k - 1 - j: k - 1 - j + s] for j in range(k)]
    if nvalid is None:
        new_state = ext[:, :, -(k - 1):]
    else:
        idx = nvalid[..., None].long() + torch.arange(k - 1, device=x.device)
        new_state = torch.take_along_dim(ext, idx[..., None], dim=2)
    y = w[:, 0][:, None, None, :].to(x.dtype) * pads[0]
    for j in range(1, k):
        y = y + w[:, j][:, None, None, :].to(x.dtype) * pads[j]
    return y + b[:, None, None, :].to(x.dtype), new_state


def _head_proj(x, w):
    """Block-diagonal per-head projection.  x (M, B, S, H, hd); w (M, H, hd, hd)."""
    return torch.einsum("mbshd,mhde->mbshe", x, w.to(x.dtype))


def _heads(lp) -> tuple[int, int]:
    """(heads, head dim) of the mLSTM layer ``lp`` holds: the model's, or
    a rank's share under a split."""
    return lp["wq"].shape[-3], lp["wq"].shape[-1]


def _head_norm(hs, h: int, eps: float):
    """Per-head group norm (xLSTM's multi-head layer norm) of (M, B, S, D)."""
    m, b, s, d = hs.shape
    hh = hs.reshape(m, b, s, h, d // h)
    mu = hh.mean(-1, keepdim=True)
    var = (hh - mu).square().mean(-1, keepdim=True)
    return ((hh - mu) * torch.rsqrt(var + eps)).reshape(m, b, s, d)


_MLSTM_MATMUL = ("w_up", "w_gates", "w_down")


def _mlstm_in(cfg: ModelConfig, lp, x, conv_state, valid=None, groups=None, heads=None):
    """The mLSTM block up to the cell: rms -> up-projection -> causal conv
    over [``conv_state``, x] -> q, k, v and the gates.  Returns (q, k, v
    (M, B, S, H, hd), lf, li (M, B, S, H) f32, z, the new conv window);
    junk steps (``valid`` False) get neutral gates.  ``heads``, where the
    heads split: ``lp`` holds the rank's H heads, and the gates are summed
    over the ranks before this rank takes its heads' pair."""
    m, b, s, d = x.shape
    h, hd = _heads(lp)
    di = h * hd
    xn = L.rms_norm_rowwise(x, lp["norm"], cfg.norm_eps)
    up = L.linear(xn, lp["w_up"], groups=groups)
    xi, z = up[..., :di], up[..., di:]
    nvalid = valid.sum(-1) if valid is not None else None
    xc, new_conv = _causal_conv(xi, lp["conv_w"], lp["conv_b"], conv_state, nvalid)
    xc = F.silu(xc)

    q = _head_proj(xc.reshape(m, b, s, h, hd), lp["wq"])
    k = _head_proj(xc.reshape(m, b, s, h, hd), lp["wk"])
    v = _head_proj(xi.reshape(m, b, s, h, hd), lp["wv"])
    gates = S.sum_over(heads, L.linear(xc, lp["w_gates"], groups=groups))
    gates = L.add_bias(gates, lp["b_gates"]).float()                # (M,B,S,2 H_all)
    h_all = gates.shape[-1] // 2
    lo = 0 if heads is None else heads.rank * h
    li = gates[..., lo:lo + h]
    lf = log_sigmoid(gates[..., h_all + lo:h_all + lo + h])
    if valid is not None:
        vm = valid[..., None]
        li = torch.where(vm, li, torch.full_like(li, NEG_INF))
        lf = torch.where(vm, lf, torch.zeros_like(lf))
    return q, k, v, lf, li, z, new_conv


def _mlstm_out(cfg: ModelConfig, lp, x, hs, z, groups=None, heads=None):
    """The mLSTM block after the cell: hs (M, B, S, H, hd) -> head norm ->
    output gate -> down-projection (summed over ``heads``' ranks) +
    residual."""
    m, b, s, _ = x.shape
    h, hd = _heads(lp)
    hs = _head_norm(hs.reshape(m, b, s, h * hd).to(x.dtype), h, cfg.norm_eps)
    hs = hs * lp["out_norm"][:, None, None, :].to(hs.dtype)
    return x + S.sum_over(heads, L.linear(hs * F.silu(z), lp["w_down"], groups=groups))


def mlstm_block(cfg: ModelConfig, lp, x, state: dict, *, chunk: int, valid=None,
                groups=None, alive=None, heads=None):
    """x (M, B, S, D); state dict(C, n, m, conv) of this layer, updated in
    place.  S > 1 runs the chunkwise form (a prefill chunk), S == 1 the
    step form, as the reference.  ``heads``: the handle where the heads
    split (``lp`` and ``state`` then hold the rank's), else None.  Returns
    the block output."""
    lp = _lane_rows(lp, groups, _MLSTM_MATMUL)
    q, k, v, lf, li, z, new_conv = _mlstm_in(cfg, lp, x, state["conv"], valid, groups, heads)
    cell = (state["C"], state["n"], state["m"])
    if x.shape[2] > 1:
        tr = lambda t: t.transpose(2, 3)                           # (M,B,H,S,...)
        hseq, new_cell = mlstm_sequence(tr(q), tr(k), tr(v), tr(lf), tr(li), cell,
                                        chunk=chunk)
        for dst, src in zip(cell, new_cell):
            dst.copy_(src)
        hs = hseq.transpose(2, 3)                                  # (M,B,S,H,hd)
    else:
        hs = mlstm_step_(cell, q[:, :, 0], k[:, :, 0], v[:, :, 0], lf[:, :, 0],
                         li[:, :, 0], alive)[:, :, None]
    if alive is not None:
        new_conv = torch.where(alive[..., None, None], new_conv, state["conv"])
    state["conv"].copy_(new_conv)
    return _mlstm_out(cfg, lp, x, hs, z, groups, heads)


def mlstm_block_seq(cfg: ModelConfig, lp, x, *, chunk: int):
    """The whole-sequence mLSTM block from a zero state (training, and a
    prefill from scratch): the cell is ``ops.mlstm_chunkwise`` (on the
    card the Hopper kernel, under autograd through its Function).  Nothing
    is written in place.  Returns (output, the layer's new state dict)."""
    m, b, _, _ = x.shape
    conv0 = x.new_zeros(m, b, cfg.conv_kernel - 1, d_inner(cfg))
    q, k, v, lf, li, z, conv = _mlstm_in(cfg, lp, x, conv0)
    tr = lambda t: t.transpose(2, 3).contiguous()                  # (M,B,H,S,...)
    hseq, (C, n, mm) = K.mlstm_chunkwise(tr(q), tr(k), tr(v), tr(lf), tr(li), chunk=chunk)
    out = _mlstm_out(cfg, lp, x, hseq.transpose(2, 3), z)
    return out, {"C": C, "n": n, "m": mm, "conv": conv}


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

_SLSTM_MATMUL = ("w_in", "w_ff_gate", "w_ff_up", "w_ff_down")


def _slstm_pre(cfg: ModelConfig, lp, x, groups=None):
    """The gate pre-activations (M, B, S, 4, D), in the storage dtype (the
    cell computes in f32); D/T of each gate on a rank whose heads split."""
    m, b, s, _ = x.shape
    xn = L.rms_norm_rowwise(x, lp["norm"], cfg.norm_eps)
    return L.linear(xn, lp["w_in"], lp["b_in"], groups).reshape(m, b, s, 4, -1)


def _slstm_out(cfg: ModelConfig, lp, x, hs, groups=None, split=None):
    """The sLSTM block after the cell: head norm + residual, then the
    gated FFN.  ``split`` (``shardings.xlstm_split``): the rank's normed
    heads are gathered over ``split.heads`` before the residual, and the
    FFN's partial summed over ``split.ffn``."""
    hs = _head_norm(hs, lp["r"].shape[-3], cfg.norm_eps)
    hs = hs * lp["out_norm"][:, None, None, :].to(hs.dtype)
    if split is not None and split.heads is not None:
        hs = split.heads.all_gather(hs, dim=-1)
    x = x + hs
    nrm = L.rms_norm_rowwise(x, lp["ffn_norm"], cfg.norm_eps)
    ffn = L.swiglu_mlp(nrm, lp["w_ff_gate"], lp["w_ff_up"], lp["w_ff_down"], groups)
    return x + S.sum_over(None if split is None else split.ffn, ffn)


def slstm_block(cfg: ModelConfig, lp, x, state: dict, *, valid=None, groups=None,
                alive=None, split=None):
    """x (M, B, S, D); state dict(c, n, h, m) each (M, B, D), updated in
    place.  The recurrent scan is the ``slstm_cell`` kernel.  Junk steps
    (``valid`` False) get neutral gate pre-activations (input -1e30,
    forget +1e30), which keep c, n and m; h, which every step emits, is
    re-taken at the last valid step afterwards.  ``split``
    (``shardings.xlstm_split``; None: whole): where the heads split,
    ``lp`` and ``state`` hold the rank's heads, (M, B, D/T) each, and the
    cell runs on them."""
    m, b, s, _ = x.shape
    # r stays the merged model's (M_w, ...) and the cell reads each lane's
    # instance through ``rows``: no per-lane copy of the recurrent weights
    lp = _lane_rows(lp, groups, _SLSTM_MATMUL + ("r",))
    rows = None if groups is None or groups.identity else groups.t32
    pre = _slstm_pre(cfg, lp, x, groups)
    d = pre.shape[-1]
    st = (state["c"], state["n"], state["h"], state["m"])
    if valid is not None:
        neutral = torch.tensor([0.0, NEG_INF, -NEG_INF, 0.0], dtype=pre.dtype,
                               device=pre.device).reshape(1, 1, 1, 4, 1)
        pre = torch.where(valid[..., None, None], pre, neutral)
        h_in = state["h"].clone()
    hs, _ = K.slstm_cell(pre, lp["r"], st, num_heads=lp["r"].shape[-3], alive=alive,
                         rows=rows)
    if valid is not None:
        nv = valid.sum(-1)                                          # (M,B)
        idx = torch.clamp(nv - 1, 0, s - 1).long()[..., None, None].expand(m, b, 1, d)
        h_sel = torch.take_along_dim(hs, idx, dim=2)[:, :, 0]
        state["h"].copy_(torch.where((nv > 0)[..., None], h_sel, h_in))
    return _slstm_out(cfg, lp, x, hs, groups, split)


def slstm_block_seq(cfg: ModelConfig, lp, x):
    """The whole-sequence sLSTM block from a zero state: the scan is
    ``ops.slstm_cell`` (on the card the Hopper kernel, under autograd
    through its Function) into a fresh state.  Returns (output, the new
    state dict)."""
    pre = _slstm_pre(cfg, lp, x)
    hs, st = K.slstm_cell(pre, lp["r"], _slstm_zero(cfg, x), num_heads=cfg.num_heads)
    return _slstm_out(cfg, lp, x, hs), dict(zip(("c", "n", "h", "m"), st))


def _slstm_zero(cfg: ModelConfig, x) -> tuple:
    """A zero sLSTM state (c, n, h, m) for x's (M, B) lanes."""
    m, b, _, d = x.shape
    z = lambda dt: torch.zeros(m, b, d, dtype=dt, device=x.device)
    return (z(torch.float32), z(torch.float32), z(x.dtype),
            torch.full((m, b, d), NEG_INF, dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


def _trunk(cfg: ModelConfig, params, x, states: dict, *, valid=None, groups=None,
           alive=None, tp=None):
    """Run every block over x (M, B, S, D), updating ``states`` in place;
    under ``tp`` on the rank's shard."""
    runs = mlstm_runs(cfg)
    split = S.xlstm_split(cfg, tp)
    for ri, n in enumerate(runs):
        if n:
            run_p, run_s = params["mlstm_runs"][ri], states["mlstm_runs"][ri]
            for i in range(n):
                x = mlstm_block(cfg, {k: run_p[k][i] for k in run_p.keys()}, x,
                                {k: v[i] for k, v in run_s.items()},
                                chunk=cfg.mlstm_chunk, valid=valid, groups=groups,
                                alive=alive, heads=split.heads)
        if ri < len(runs) - 1:
            x = slstm_block(cfg, params["slstm"][ri], x, states["slstm"][ri],
                            valid=valid, groups=groups, alive=alive, split=split)
    return x


def _trunk_seq(cfg: ModelConfig, params, x, *, remat: bool = False, keep_state: bool = False):
    """Every block over the whole sequence x (M, B, S, D) from a zero
    state, nothing written in place; ``remat`` checkpoints each layer (the
    reference's ``_trunk``).  Returns x, and with ``keep_state`` also the
    final states in ``make_state``'s layout."""
    runs = mlstm_runs(cfg)
    states = {"mlstm_runs": [], "slstm": []}

    def run(block, x):
        # a layer's recompute under remat runs after the loop has moved on:
        # ``block`` binds everything it reads
        if keep_state:
            return block(x)
        return L.remat(lambda xc: block(xc)[0], remat)(x), None

    for ri, n in enumerate(runs):
        sts = []
        for i in range(n):
            x, st = run(lambda xc, run_p=params["mlstm_runs"][ri], i=i: mlstm_block_seq(
                cfg, {k: run_p[k][i] for k in run_p.keys()}, xc, chunk=cfg.mlstm_chunk), x)
            sts.append(st)
        if keep_state:
            states["mlstm_runs"].append(
                {k: torch.stack([st[k] for st in sts]) for k in sts[0]} if n else None)
        if ri < len(runs) - 1:
            x, st = run(lambda xc, ri=ri: slstm_block_seq(cfg, params["slstm"][ri], xc), x)
            states["slstm"].append(st)
    return (x, states) if keep_state else x


def _embed_in(cfg, params, tokens, instances=None):
    return L.embed(tokens, params["embed"], torch_dtype(cfg.dtype), instances)


def forward(cfg: ModelConfig, params, tokens, *, remat: bool = False):
    """Whole-sequence forward (training): logits (M, B, S, V) f32."""
    x = _trunk_seq(cfg, params, _embed_in(cfg, params, tokens), remat=remat)
    n = L.rms_norm_rowwise(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(n, params["lm_head"])


def prefill(cfg: ModelConfig, params, tokens, *, state=None):
    """A whole prompt: (last logits (M, B, V) f32, the recurrent states).
    From scratch the blocks run their whole-sequence forms (the mLSTM and
    sLSTM kernels from a zero state); a given ``state`` is continued
    exactly by the chunk forms, on a copy of it."""
    x = _embed_in(cfg, params, tokens)
    if state is None:
        x, states = _trunk_seq(cfg, params, x, keep_state=True)
    else:
        states = tree_map(torch.clone, state)
        x = _trunk(cfg, params, x, states)
    n = L.rms_norm_rowwise(x[:, :, -1:], params["final_norm"], cfg.norm_eps)
    return L.unembed(n, params["lm_head"])[:, :, 0], states


def prefill_chunk(cfg: ModelConfig, params, batch, carry, offset, *,
                  instances: list[int] | None = None, tp=None) -> dict:
    """One chunk of a state-carrying prefill.  The state is positionless,
    so ``offset`` is unused.  batch["valid"] (M, B, C), when present,
    marks the real rows; junk rows are gate-neutral in every cell.
    ``instances`` maps row i of the batch to row ``instances[i]`` of the
    merged model; under ``tp`` the params and carry are the rank's
    shard."""
    x = _embed_in(cfg, params, batch["tokens"], instances)
    groups = None
    if instances is not None:
        groups = L.LaneGroups(instances, params["final_norm"].shape[0], x.device)
    _trunk(cfg, params, x, carry["cache"], valid=batch.get("valid"), groups=groups, tp=tp)
    return carry


def decode_step(cfg: ModelConfig, params, states, tokens, pos=None, *, alive=None, tp=None):
    """One token.  tokens (M, B, 1); pos unused.  Returns (logits
    (M, B, V) f32, states updated in place); under ``tp`` every rank gets
    the whole vocab's logits."""
    x = _trunk(cfg, params, _embed_in(cfg, params, tokens), states, alive=alive, tp=tp)
    n = L.rms_norm_rowwise(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(n, params["lm_head"])[:, :, 0]
    vtp = S.vocab_group(cfg, tp)
    return (logits if vtp is None else vtp.all_gather(logits, dim=-1)), states


def decode_step_sample(cfg: ModelConfig, params, states, tokens, pos=None, *, alive=None,
                       tp=None):
    """Greedy decode step: (next token (M, B) int32, states updated in
    place).  Final norm, logits and argmax are the fused logits kernel
    (per vocab slice under tensor parallelism, then a cross-rank
    combine)."""
    x = _trunk(cfg, params, _embed_in(cfg, params, tokens), states, alive=alive, tp=tp)
    tok = K.logits_sample_sharded(x[:, :, 0], params["final_norm"], params["lm_head"],
                                  tp=S.vocab_group(cfg, tp), eps=cfg.norm_eps)
    return tok, states


def make_state(cfg: ModelConfig, m: int, b: int, device, tp=None) -> dict:
    """The (M, B) grid's recurrent state, zero with m = -1e30; a rank's
    shard holds its heads (C, n, m), channels (conv) and sLSTM widths."""
    parts = 1 if S.xlstm_split(cfg, tp).heads is None else tp.size
    d, h = cfg.d_model // parts, cfg.num_heads // parts
    di = d_inner(cfg) // parts
    hd = di // h
    f32, act = torch.float32, torch_dtype(cfg.dtype)
    z = lambda shape, dt=f32: torch.zeros(shape, dtype=dt, device=device)
    neg = lambda shape: torch.full(shape, NEG_INF, dtype=f32, device=device)
    runs = mlstm_runs(cfg)
    st = {"mlstm_runs": [], "slstm": []}
    for ri, n in enumerate(runs):
        st["mlstm_runs"].append({
            "C": z((n, m, b, h, hd, hd)), "n": z((n, m, b, h, hd)), "m": neg((n, m, b, h)),
            "conv": z((n, m, b, cfg.conv_kernel - 1, di), act),
        } if n else None)
        if ri < len(runs) - 1:
            st["slstm"].append({"c": z((m, b, d)), "n": z((m, b, d)),
                                "h": z((m, b, d), act), "m": neg((m, b, d))})
    return st


def init_chunk_carry(cfg: ModelConfig, m: int, b: int, cache_len: int, device,
                     tp=None) -> dict:
    return {"cache": make_state(cfg, m, b, device, tp)}


def state_axes(cfg: ModelConfig) -> dict:
    """Logical axes of the recurrent state tree."""
    runs = mlstm_runs(cfg)
    ax = {"mlstm_runs": [], "slstm": []}
    for ri, n in enumerate(runs):
        ax["mlstm_runs"].append({
            "C": ("layers", "instances", "batch", "heads", None, None),
            "n": ("layers", "instances", "batch", "heads", None),
            "m": ("layers", "instances", "batch", "heads"),
            "conv": ("layers", "instances", "batch", None, "mlp"),
        } if n else None)
        if ri < len(runs) - 1:
            ax["slstm"].append({k: ("instances", "batch", None) for k in ("c", "n", "h", "m")})
    return ax


def chunk_carry_axes(cfg: ModelConfig) -> dict:
    return {"cache": state_axes(cfg)}


def take_state(cfg: ModelConfig, state, m: int, b: int):
    """Slot (m, b) of an (M, B) state grid (views, singleton dims kept)."""
    return tree_take_slot(state, state_axes(cfg), m, b)


def put_state(cfg: ModelConfig, grid, one, m: int, b: int):
    """Write a single-slot state into grid slot (m, b), in place."""
    return tree_put_slot(grid, state_axes(cfg), one, m, b)
