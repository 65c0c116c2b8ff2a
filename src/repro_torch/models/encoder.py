"""BERT / XLNet-style encoders, the paper's NLP evaluation models (port of
``repro.models.encoder``).

Instance-axis form: every matmul is instance-batched (matmul -> batch
matmul) and every layer norm is per instance (layer norm -> group norm).
The paper evaluates them at sequence length 128, with the per-task heads
left unmerged (not part of this module).  XLNet uses Transformer-XL
relative-position attention: content and position terms with the u / v
biases and the relative shift.

Storage, as ``layers.linear`` computes: the matmul weights, biases and
the u / v biases in ``cfg.dtype`` (the reference casts them to the
activation dtype at every use); ``wr`` stays in f32 because the reference
projects the relative encodings in f32 before it casts them; the
embeddings and the layer-norm parameters stay in ``param_dtype``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.common import Factory, MergedParams

ACT_LEAVES = ("wq", "wk", "wv", "wo", "w1", "b1", "w2", "b2", "u", "v")


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def build_params(cfg: ModelConfig, f: Factory, *, xlnet: bool = False) -> dict:
    m, d, h, hd, ff, n = (cfg.num_instances, cfg.d_model, cfg.num_heads, cfg.head_dim,
                          cfg.d_ff, cfg.num_layers)
    lp = {
        "wq": f((n, m, d, h * hd), init="fan_in"),
        "wk": f((n, m, d, h * hd), init="fan_in"),
        "wv": f((n, m, d, h * hd), init="fan_in"),
        "wo": f((n, m, h * hd, d), init="fan_in"),
        "ln1_s": f((n, m, d), init="ones"),
        "ln1_b": f((n, m, d), init="zeros"),
        "w1": f((n, m, d, ff), init="fan_in"),
        "b1": f((n, m, ff), init="zeros"),
        "w2": f((n, m, ff, d), init="fan_in"),
        "b2": f((n, m, d), init="zeros"),
        "ln2_s": f((n, m, d), init="ones"),
        "ln2_b": f((n, m, d), init="zeros"),
    }
    if xlnet:
        lp["wr"] = f((n, m, d, h * hd), init="fan_in")
        lp["u"] = f((n, m, h, hd), init="zeros")
        lp["v"] = f((n, m, h, hd), init="zeros")
    p = {"embed": f((m, cfg.vocab_size, d)), "layers": lp}
    if not xlnet:
        p["pos_embed"] = f((m, cfg.max_target_positions or 512, d))
    return p


def storage_dtypes(cfg: ModelConfig, tree: dict) -> dict:
    """Cast a parameter tree to the port's storage dtypes."""
    act, par = torch_dtype(cfg.dtype), torch_dtype(cfg.param_dtype)
    out = {k: v.to(par) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: v.to(torch.float32 if k == "wr" else act if k in ACT_LEAVES else par)
                     for k, v in tree["layers"].items()}
    return out


def init(cfg: ModelConfig, generator: torch.Generator | None, device, *,
         xlnet: bool = False) -> MergedParams:
    """Random parameters with the reference's distributions, drawn from
    ``generator`` (on ``device``), in the port's storage dtypes."""
    f = Factory(generator, torch_dtype(cfg.param_dtype), torch.device(device))
    return MergedParams(storage_dtypes(cfg, build_params(cfg, f, xlnet=xlnet)))


def _sinusoid_rel(s: int, d: int) -> np.ndarray:
    """Transformer-XL relative positions s-1 .. 0 encoded sinusoidally."""
    pos = np.arange(s - 1, -1, -1)[:, None]
    inv = 1.0 / (10000 ** (np.arange(0, d, 2) / d))
    ang = pos * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _rel_enc(s: int, d: int, device: torch.device) -> torch.Tensor:
    """:func:`_sinusoid_rel` on the device, made once per (s, d, device)."""
    return torch.from_numpy(_sinusoid_rel(s, d)).to(device)


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(..., S_q, S_k) relative-score shift (the Transformer-XL trick)."""
    *lead, sq, sk = x.shape
    x = F.pad(x, (1, 0)).reshape(*lead, sk + 1, sq)
    return x[..., 1:, :].reshape(*lead, sq, sk)


def _attention(cfg: ModelConfig, lp: dict, x: torch.Tensor, *, xlnet: bool, rel_enc=None):
    """Bidirectional MHA at S <= 512 (the paper's setting): direct S x S
    scores, softmax in f32 cast back to the activation dtype."""
    m, b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = L.linear(x, lp["wq"]).reshape(m, b, s, h, hd)
    k = L.linear(x, lp["wk"]).reshape(m, b, s, h, hd)
    v = L.linear(x, lp["wv"]).reshape(m, b, s, h, hd)
    if xlnet:
        r = torch.matmul(rel_enc, lp["wr"].float()).reshape(m, s, h, hd)
        ac = torch.einsum("mbqhd,mbkhd->mbhqk", q + lp["u"][:, None, None].to(q.dtype), k)
        bd = torch.einsum("mbqhd,mkhd->mbhqk", q + lp["v"][:, None, None].to(q.dtype),
                          r.to(q.dtype))
        scores = ac + _rel_shift(bd)
    else:
        scores = torch.einsum("mbqhd,mbkhd->mbhqk", q, k)
    # the reference divides by a numpy scalar, which promotes to f32
    p = torch.softmax(scores.float() / math.sqrt(hd), dim=-1).to(x.dtype)
    o = torch.einsum("mbhqk,mbkhd->mbqhd", p, v).reshape(m, b, s, h * hd)
    return L.linear(o, lp["wo"])


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *, xlnet: bool = False):
    """tokens (M, B, S) -> final hidden states (M, B, S, D) (post-LN stack)."""
    s = tokens.shape[2]
    x = L.embed(tokens, params["embed"], torch_dtype(cfg.dtype))
    rel_enc = None
    if xlnet:
        rel_enc = _rel_enc(s, cfg.d_model, x.device)
    else:
        x = x + params["pos_embed"][:, None, :s].to(x.dtype)
    layers = params["layers"]
    names = list(layers.keys())
    for i in range(layers["wq"].shape[0]):
        lp = {k: layers[k][i] for k in names}
        a = _attention(cfg, lp, x, xlnet=xlnet, rel_enc=rel_enc)
        x = L.layer_norm(x + a, lp["ln1_s"], lp["ln1_b"], cfg.norm_eps)
        f = L.gelu_mlp(x, lp["w1"], lp["b1"], lp["w2"], lp["b2"])
        x = L.layer_norm(x + f, lp["ln2_s"], lp["ln2_b"], cfg.norm_eps)
    return x
