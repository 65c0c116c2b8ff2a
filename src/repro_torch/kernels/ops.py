"""Dispatch of the port's kernels by device, with launch counters.

Each wrapper runs the plain PyTorch version when its tensors lie on the
CPU, and launches the hand-written Hopper kernel when they lie on a CUDA
device -- or raises.  There is no switch and no fallback: a kernel that
fails to build or launch on the card is an error.  ``launches`` counts
the wrapper's kernel calls (not the plain ones), so a run can show that
its main path went through the kernels.
"""
from __future__ import annotations

from repro_torch.kernels import chunk_prefill_attn as _cpa
from repro_torch.kernels import decode_attn as _da
from repro_torch.kernels import decode_layer as _dl
from repro_torch.kernels import fused_matmul as _fm
from repro_torch.kernels import group_norm as _gn
from repro_torch.kernels import mlstm_chunk as _ml
from repro_torch.kernels import slstm_cell as _sc


class Kernel:
    """A kernel wrapper: plain version on the CPU, kernel on CUDA."""

    def __init__(self, name: str, plain, cuda):
        self.name = name
        self.plain = plain
        self.cuda = cuda
        self.launches = 0

    def __call__(self, probe, *args, **kw):
        dev = probe.device.type
        if dev == "cpu":
            return self.plain(*args, **kw)
        if dev != "cuda":
            raise ValueError(f"{self.name}: no kernel for device {probe.device}")
        self.launches += 1
        return self.cuda(*args, **kw)


_decode_layer = Kernel("decode_layer", _dl.decode_layer_plain, _dl.decode_layer_cuda)
_logits = Kernel("logits_sample", _dl.logits_argmax_plain, _dl.logits_argmax_cuda)
_chunk = Kernel("chunk_prefill_attention", _cpa.chunk_prefill_attention_plain,
                _cpa.chunk_prefill_attention_cuda)

_slstm = Kernel("slstm_cell", _sc.slstm_cell_plain, _sc.slstm_cell_cuda)
_decode_attn = Kernel("decode_attention", _da.decode_attention_plain,
                      _da.decode_attention_cuda)

_fused_matmul = Kernel("fused_matmul", _fm.fused_matmul_plain, _fm.fused_matmul_cuda)
_group_rms = Kernel("group_rms_norm", _gn.group_rms_norm_plain, _gn.group_rms_norm_cuda)
_mlstm = Kernel("mlstm_chunkwise", _ml.mlstm_chunkwise_plain, _ml.mlstm_chunkwise_cuda)

KERNELS = (_decode_layer, _logits, _chunk, _slstm, _decode_attn, _fused_matmul, _group_rms,
           _mlstm)


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


def logits_argmax(x, scale, head, *, eps: float = 1e-5):
    """Final rms + f32 logits + greedy argmax -> (tok int32, val f32)."""
    return _logits(x, x, scale, head, eps=eps)


def logits_sample(x, scale, head, *, eps: float = 1e-5):
    """Greedy tokens (M, B) int32, first-occurrence ties."""
    return logits_argmax(x, scale, head, eps=eps)[0]


def chunk_prefill_attention(q, k, v, offset, *, s_cache: int, pin: int = 0,
                            window: int = 0, sink: int = 0, causal: bool = True):
    """Chunked-prefill GQA attention over [cache before the chunk, chunk]."""
    return _chunk(q, q, k, v, offset, s_cache=s_cache, pin=pin, window=window,
                  sink=sink, causal=causal)


def slstm_cell(pre, r, state, *, num_heads: int, alive=None):
    """The sLSTM scan over S steps; state (c, n, h, m) updated in place.
    Returns (hs (M, B, S, D), state)."""
    return _slstm(pre, pre, r, state, num_heads=num_heads, alive=alive)


def decode_attention(q, k, v, kv_len):
    """Single-token GQA attention over the first ``kv_len`` (M, B) slots
    of k, v (M, B, S, KVH, hd); 1 <= kv_len <= S.  Returns (M, B, H, hd)."""
    return _decode_attn(q, q, k, v, kv_len)


def fused_matmul(x, w, b=None):
    """The NetFuse merged matmul x (M, T, D) @ w (M, D, F) [+ b (M, F)],
    f32 sums, in x's dtype."""
    return _fused_matmul(x, x, w, b)


def group_rms_norm(x, scale, *, eps: float = 1e-5):
    """Per-instance RMS norm of x (M, T, D) with scale (M, D), f32 stats."""
    return _group_rms(x, x, scale, eps=eps)


def mlstm_chunkwise(q, k, v, lf, li, *, chunk: int = 64):
    """Chunkwise mLSTM from zero state over q, k, v (M, B, H, S, hd).
    Returns (h, (C, n, m))."""
    return _mlstm(q, q, k, v, lf, li, chunk=chunk)
