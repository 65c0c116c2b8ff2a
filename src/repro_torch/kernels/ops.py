"""Dispatch of the port's kernels by device, with launch counters.

Each wrapper runs the plain PyTorch version when its tensors lie on the
CPU, and launches the hand-written Hopper kernel when they lie on a CUDA
device -- or raises.  There is no switch and no fallback: a kernel that
fails to build or launch on the card is an error.  ``launches`` counts
the wrapper's kernel calls (not the plain ones), so a run can show that
its main path went through the kernels.

The ``*_sharded`` functions are the tensor-parallel forms (the
reference's ``shard_map`` wrappers) over a rank's shard and its
``TensorParallel`` handle, with the collectives written out.  Three of
the reference's wrappers are rank-local: ``decode_attention_sharded``
launches the decode-attention kernel on a rank's block of heads,
``fused_matmul_sharded`` the merged-matmul kernel on a rank's block of
instances and output features, and ``chunk_prefill_attention_sharded``
needs no function of its own (the model computes q, k and v for the
rank's heads and calls :func:`chunk_prefill_attention` on them).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import chunk_prefill_attn as _cpa
from repro_torch.kernels import decode_attn as _da
from repro_torch.kernels import decode_layer as _dl
from repro_torch.kernels import fused_matmul as _fm
from repro_torch.kernels import group_norm as _gn
from repro_torch.kernels import mlstm_chunk as _ml
from repro_torch.kernels import slstm_cell as _sc


def _requires_grad(x) -> bool:
    """Whether a tensor in ``x`` (nested in dicts, lists, tuples) requires
    a gradient."""
    if isinstance(x, torch.Tensor):
        return x.requires_grad
    if isinstance(x, dict):
        x = x.values()
    elif not isinstance(x, (list, tuple)):
        return False
    return any(_requires_grad(v) for v in x)


class Kernel:
    """A kernel wrapper: plain version on the CPU, kernel on CUDA.

    Under autograd (grad enabled and an input requiring a gradient) a
    kernel with a ``grad`` form runs through it: ``grad(fwd, *args)``
    wraps the forward callable of the device (the kernel's launch, or the
    plain version on the CPU) in a ``torch.autograd.Function`` whose
    backward differentiates the reference's math (the recurrent kernels)
    or calls the same callable on the gradient's products (the merged
    matmul, whose backward launches count as its forward's do).  A CUDA
    launch of a kernel without one raises there: its output would carry
    no ``grad_fn``, and the parameters upstream would silently get no
    gradient.  On the CPU the plain version is differentiable as it is."""

    def __init__(self, name: str, plain, cuda, grad=None):
        self.name = name
        self.plain = plain
        self.cuda = cuda
        self.grad = grad
        self.launches = 0

    def launch(self, *args, **kw):
        self.launches += 1
        return self.cuda(*args, **kw)

    def __call__(self, probe, *args, **kw):
        dev = probe.device.type
        if dev not in ("cpu", "cuda"):
            raise ValueError(f"{self.name}: no kernel for device {probe.device}")
        fwd = self.plain if dev == "cpu" else self.launch
        if torch.is_grad_enabled() and _requires_grad((args, kw)):
            if self.grad is not None:
                return self.grad(fwd, *args, **kw)
            if dev == "cuda":
                raise RuntimeError(
                    f"{self.name}: the kernel has no backward; it was launched on inputs "
                    "that require a gradient (run it under torch.no_grad())")
        return fwd(*args, **kw)


_decode_layer = Kernel("decode_layer", _dl.decode_layer_plain, _dl.decode_layer_cuda)
_attn_phase = Kernel("decode_layer_attn", _dl.decode_layer_attn_plain,
                     _dl.decode_layer_attn_cuda)
_ffn_phase = Kernel("decode_layer_ffn", _dl.ffn_plain, _dl.ffn_cuda)
_logits = Kernel("logits_sample", _dl.logits_argmax_plain, _dl.logits_argmax_cuda)
_chunk = Kernel("chunk_prefill_attention", _cpa.chunk_prefill_attention_plain,
                _cpa.chunk_prefill_attention_cuda)

_slstm = Kernel("slstm_cell", _sc.slstm_cell_plain, _sc.slstm_cell_cuda,
                grad=_sc.slstm_cell_grad)
_decode_attn = Kernel("decode_attention", _da.decode_attention_plain,
                      _da.decode_attention_cuda)
_decode_attn_sh = Kernel("decode_attention_sharded", _da.decode_attention_plain,
                         _da.decode_attention_cuda)

_fused_matmul = Kernel("fused_matmul", _fm.fused_matmul_plain, _fm.fused_matmul_cuda,
                       grad=_fm.fused_matmul_grad)
_fused_matmul_sh = Kernel("fused_matmul_sharded", _fm.fused_matmul_plain,
                          _fm.fused_matmul_cuda)
_group_rms = Kernel("group_rms_norm", _gn.group_rms_norm_plain, _gn.group_rms_norm_cuda)
_mlstm = Kernel("mlstm_chunkwise", _ml.mlstm_chunkwise_plain, _ml.mlstm_chunkwise_cuda,
                grad=_ml.mlstm_chunkwise_grad)

KERNELS = (_decode_layer, _logits, _chunk, _slstm, _decode_attn, _fused_matmul, _group_rms,
           _mlstm, _attn_phase, _ffn_phase, _decode_attn_sh, _fused_matmul_sh)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def decode_layer(lp, x, ck, cv, pos, *, num_heads, head_dim, rope_theta,
                 window: int = 0, eps: float = 1e-5, alive=None):
    """One dense decode layer for the whole (M, B) grid, ring append in
    place.  Returns (x_out, ck, cv)."""
    return _decode_layer(x, lp, x, ck, cv, pos, num_heads=num_heads,
                         head_dim=head_dim, rope_theta=rope_theta,
                         window=window, eps=eps, alive=alive)


def decode_layer_attn(lp, x, ck, cv, pos, *, num_heads, head_dim, rope_theta,
                      window: int = 0, eps: float = 1e-5, alive=None):
    """The attention half of a decode layer over ``num_heads`` query heads
    of ``lp``, ring append in place: (out-proj partial, ck, cv)."""
    return _attn_phase(x, lp, x, ck, cv, pos, num_heads=num_heads, head_dim=head_dim,
                       rope_theta=rope_theta, window=window, eps=eps, alive=alive)


def decode_layer_ffn(x, mlp_norm, w_gate, w_up, w_down, *, eps: float = 1e-5):
    """The FFN half of a decode layer: the down-proj partial."""
    return _ffn_phase(x, x, mlp_norm, w_gate, w_up, w_down, eps=eps)


def decode_layer_sharded(lp, x, ck, cv, pos, *, tp, num_heads, head_dim, rope_theta,
                         window: int = 0, eps: float = 1e-5, alive=None):
    """``decode_layer`` on a rank's shard (the reference's
    ``decode_layer_sharded``).  ``tp`` is the handle when the layer's
    heads and FFN are split over its ranks (``lp``, ck and cv then hold
    this rank's share of the model's ``num_heads``), ``None`` when the
    layer is held whole.  Split, the out-proj and the down-proj contract
    sharded dims, so the layer is the attention phase, a sum over the
    ranks, the FFN phase and a second sum: 2 phases and 2 collectives per
    layer and rank.  A whole layer is one ``decode_layer``."""
    kw = dict(head_dim=head_dim, rope_theta=rope_theta, window=window, eps=eps, alive=alive)
    if tp is None:
        return decode_layer(lp, x, ck, cv, pos, num_heads=num_heads, **kw)
    part, ck, cv = decode_layer_attn(lp, x, ck, cv, pos, num_heads=num_heads // tp.size, **kw)
    x2 = x + tp.all_reduce_sum(part)
    down = decode_layer_ffn(x2, lp["mlp_norm"], lp["w_gate"], lp["w_up"], lp["w_down"],
                            eps=eps)
    return x2 + tp.all_reduce_sum(down), ck, cv


def logits_argmax(x, scale, head, *, eps: float = 1e-5):
    """Final rms + f32 logits + greedy argmax -> (tok int32, val f32)."""
    return _logits(x, x, scale, head, eps=eps)


def logits_sample(x, scale, head, *, eps: float = 1e-5):
    """Greedy tokens (M, B) int32, first-occurrence ties."""
    return logits_argmax(x, scale, head, eps=eps)[0]


def logits_sample_sharded(x, scale, head, *, tp, eps: float = 1e-5):
    """Greedy tokens (the reference's ``logits_sample_sharded``).  ``tp``
    is the handle when ``head`` (M, D, V/T) is this rank's vocab slice,
    ``None`` when it is the whole head.  Split: the kernel's local (max,
    first index), then the global first-occurrence argmax from two small
    all-reduces, on any backend: the max of the values, then the min of
    the global indices of the ranks that hold it.  The reference's
    all-gather form picks the same token."""
    if tp is None:
        return logits_sample(x, scale, head, eps=eps)
    tok, val = logits_argmax(x, scale, head, eps=eps)
    best = tp.all_reduce(val.clone(), dist.ReduceOp.MAX)
    cand = torch.where(val == best, tok + tp.rank * head.shape[2],
                       torch.full_like(tok, torch.iinfo(torch.int32).max))
    return tp.all_reduce(cand, dist.ReduceOp.MIN)


def chunk_prefill_attention(q, k, v, offset, *, s_cache: int, pin: int = 0,
                            window: int = 0, sink: int = 0, causal: bool = True):
    """Chunked-prefill GQA attention over [cache before the chunk, chunk]."""
    return _chunk(q, q, k, v, offset, s_cache=s_cache, pin=pin, window=window,
                  sink=sink, causal=causal)


def slstm_cell(pre, r, state, *, num_heads: int, alive=None, rows=None):
    """The sLSTM scan over S steps; state (c, n, h, m) updated in place.
    ``rows`` (M,) int32, when given, names the instance of r (M_r, ...)
    each row reads.  Returns (hs (M, B, S, D), state).  Under autograd
    the scan runs through ``slstm_cell.Scan``: the state passed in is not
    written, and the new state comes back as new tensors."""
    return _slstm(pre, pre, r, state, num_heads=num_heads, alive=alive, rows=rows)


def decode_attention(q, k, v, kv_len):
    """Single-token GQA attention over the first ``kv_len`` (M, B) slots
    of k, v (M, B, S, KVH, hd); 1 <= kv_len <= S.  Returns (M, B, H, hd)."""
    return _decode_attn(q, q, k, v, kv_len)


def decode_attention_sharded(q, k, v, kv_len, *, plan, tp, num_kv_heads: int):
    """``decode_attention`` on a rank's block (the reference's
    ``decode_attention_sharded``): rank-local, no collective.  ``tp`` is
    the ``TensorParallel`` handle (only its rank and size are read), or
    None on one device, where this is :func:`decode_attention`.  ``plan``
    is ``tp_head_plan`` of the model's heads over the ranks:

    * None: the q heads do not split; q and k, v hold every head;
    * "kv": q (M, B, H/T, hd) the rank's heads, k, v its KVH/T kv heads;
    * "expand": q the rank's H/T heads, k, v (M, B, S, hi - lo, hd) the
      kv heads [lo, hi) they read (``decode_attn.rank_kv_heads``).  Where
      the q heads group evenly over them (every rank of hymba-1.5b and
      hymba-smoke: all its q heads share one kv head) the kernel reads
      the cache shard as it is; where they straddle a group boundary
      unevenly, k and v are repeated to one head per q head, the
      reference's ``jnp.repeat``, a contiguous copy.

    Under a handle the launch counts as ``decode_attention_sharded``."""
    if tp is None:
        return decode_attention(q, k, v, kv_len)
    if plan == "expand":
        lo, hi, index = _da.rank_kv_heads(q.shape[2] * tp.size, num_kv_heads, tp.size,
                                          tp.rank)
        if k.shape[3] != hi - lo:
            raise ValueError(f"rank {tp.rank} reads kv heads [{lo}, {hi}); its cache shard "
                             f"holds {k.shape[3]}")
        if index is not None:
            idx = torch.tensor(index, device=k.device)
            k, v = k.index_select(3, idx), v.index_select(3, idx)
    return _decode_attn_sh(q, q, k, v, kv_len)


def fused_matmul(x, w, b=None):
    """The NetFuse merged matmul x (M, T, D) @ w (M, D, F) [+ b (M, F)],
    f32 sums, in x's dtype; under autograd through
    ``fused_matmul.Merged``, whose backward launches the kernel twice (dx
    and dw)."""
    return _fused_matmul(x, x, w, b)


def fused_matmul_sharded(x, w, b=None, *, data, tp):
    """``fused_matmul`` on a rank's block of a (data=D, model=T) mesh (the
    reference's ``fused_matmul_sharded``): x (M_l, T, D), w (M_l, D, F_l)
    and b (M_l, F_l) as ``fused_matmul.rank_block`` cuts them; rank-local,
    no collective.  ``data`` and ``tp`` are the rank's handles, both None
    on one device, where this is :func:`fused_matmul`.  Under a handle
    the launch counts as ``fused_matmul_sharded``."""
    if data is None and tp is None:
        return fused_matmul(x, w, b)
    return _fused_matmul_sh(x, x, w, b)


def group_rms_norm(x, scale, *, eps: float = 1e-5):
    """Per-instance RMS norm of x (M, T, D) with scale (M, D), f32 stats."""
    return _group_rms(x, x, scale, eps=eps)


def mlstm_chunkwise(q, k, v, lf, li, *, chunk: int = 64):
    """Chunkwise mLSTM from zero state over q, k, v (M, B, H, S, hd).
    Returns (h, (C, n, m)); under autograd through
    ``mlstm_chunk.Chunkwise``."""
    return _mlstm(q, q, k, v, lf, li, chunk=chunk)
