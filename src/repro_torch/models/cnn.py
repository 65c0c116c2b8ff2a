"""ResNet-50 / ResNeXt-50, the paper's CNN evaluation models (port of
``repro.models.cnn``).

They run in the paper's concat form: merged activations are the
channel-concatenated (B, M*C, H, W) tensors (channels-last in memory, the
reference's NHWC), every conv is a grouped conv with ``groups = M *
cardinality`` (paper Appendix A), batch norms concatenate channels, and
the per-task FC heads stay unmerged (paper section 6).  Inference only:
batch norm uses the stored statistics.  The model computes in the dtype
of its weights and images (f32 from the factory), as the reference does.

Conv weights are kept in ``F.conv2d``'s layout: the reference's
(M, K, K, Cin/g, Cout) leaf becomes (M, Cout, Cin/g, K, K) once, at load
(:func:`storage_dtypes`), laid out in memory as (M, Cout, K, K, Cin/g),
so that ``reshape(M*Cout, Cin/g, K, K)`` is a channels-last view and no
forward transposes a weight.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fused_ops
from repro_torch.models.common import Factory, MergedParams


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def stage_widths(cfg: ModelConfig) -> list[tuple[int, int]]:
    """[(inner, out)] per stage; ResNeXt uses 2x inner width."""
    mult = 2 if cfg.cnn_cardinality > 1 else 1
    return [(cfg.cnn_width * (2 ** s) * mult, cfg.cnn_width * 4 * (2 ** s))
            for s in range(len(cfg.cnn_stage_blocks))]


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _conv_bn(f: Factory, m: int, k: int, cin: int, cout: int) -> dict:
    return {
        "w": f((m, k, k, cin, cout), init="fan_in"),
        "bn_scale": f((m, cout), init="ones"),
        "bn_bias": f((m, cout), init="zeros"),
        "bn_mean": f((m, cout), init="zeros"),
        "bn_var": f((m, cout), init="ones"),
    }


def build_params(cfg: ModelConfig, f: Factory) -> dict:
    """The reference's tree and layouts: conv weights (M, K, K, Cin/g, Cout)."""
    m, card = cfg.num_instances, cfg.cnn_cardinality
    p = {"stem": _conv_bn(f, m, 7, 3, cfg.cnn_width)}
    cin = cfg.cnn_width
    stages = []
    for si, nblocks in enumerate(cfg.cnn_stage_blocks):
        inner, cout = stage_widths(cfg)[si]
        blocks = []
        for bi in range(nblocks):
            blk = {
                "reduce": _conv_bn(f, m, 1, cin, inner),
                "conv3": _conv_bn(f, m, 3, inner // card, inner),
                "expand": _conv_bn(f, m, 1, inner, cout),
            }
            if bi == 0:
                blk["down"] = _conv_bn(f, m, 1, cin, cout)
            blocks.append(blk)
            cin = cout
        stages.append(blocks)
    p["stages"] = stages
    p["head"] = {"w": f((m, cin, cfg.num_classes), init="fan_in")}
    return p


def storage_dtypes(cfg: ModelConfig, tree: dict) -> dict:
    """Cast a reference-layout tree to ``param_dtype`` and lay the conv
    weights out for ``F.conv2d`` (see the module docstring)."""
    par = torch_dtype(cfg.param_dtype)

    def conv(x, name=""):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        if name == "w" and x.ndim == 5:     # (M, K, K, Cin/g, Cout)
            return x.to(par).permute(0, 4, 1, 2, 3).contiguous().permute(0, 1, 4, 2, 3)
        return x.to(par)

    return conv(tree)


def init(cfg: ModelConfig, generator: torch.Generator | None, device) -> MergedParams:
    """Random parameters with the reference's distributions, drawn from
    ``generator`` (on ``device``), in the port's storage layout."""
    f = Factory(generator, torch_dtype(cfg.param_dtype), torch.device(device))
    return MergedParams(storage_dtypes(cfg, build_params(cfg, f)))


# ---------------------------------------------------------------------------
# forward (concat form)
# ---------------------------------------------------------------------------


def _to_concat(x: torch.Tensor) -> torch.Tensor:
    """(M, B, H, W, C) -> (B, M*C, H, W), channels-last in memory."""
    m, b, h, w, c = x.shape
    return x.permute(1, 2, 3, 0, 4).reshape(b, h, w, m * c).permute(0, 3, 1, 2)


def _conv_bn_relu(p, x: torch.Tensor, m: int, *, stride: int = 1, groups: int = 1,
                  relu: bool = True) -> torch.Tensor:
    """x (B, M*Cin, H, W); weight (M, Cout, Cin/g, K, K) -> grouped conv
    with M*groups groups, then the concatenated inference batch norm."""
    w = p["w"]
    y = fused_ops.conv2d_same(x, w.reshape(-1, *w.shape[2:]), groups=m * groups,
                              stride=stride)
    y = F.batch_norm(y, p["bn_mean"].reshape(-1), p["bn_var"].reshape(-1),
                     p["bn_scale"].reshape(-1), p["bn_bias"].reshape(-1), False, 0.0, 1e-5)
    return F.relu(y) if relu else y


def forward(cfg: ModelConfig, params, images: torch.Tensor) -> list[torch.Tensor]:
    """images (M, B, H, W, 3) -> per-task logits, a list of M (B, classes)
    (paper section 6: backbone merged, task heads separate)."""
    m = images.shape[0]
    card = cfg.cnn_cardinality
    x = _to_concat(images)
    x = _conv_bn_relu(params["stem"], x, m, stride=2)
    x = fused_ops.max_pool_same(x, 3, 2)
    for si, blocks in enumerate(params["stages"]):
        for bi, blk in enumerate(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            res = x
            y = _conv_bn_relu(blk["reduce"], x, m)
            y = _conv_bn_relu(blk["conv3"], y, m, stride=stride, groups=card)
            y = _conv_bn_relu(blk["expand"], y, m, relu=False)
            if "down" in blk:
                res = _conv_bn_relu(blk["down"], x, m, stride=stride, relu=False)
            x = F.relu(y + res)
    feats = x.mean(dim=(2, 3))                                   # (B, M*C)
    feats = feats.reshape(feats.shape[0], m, -1)
    head = params["head"]["w"]
    return [feats[:, i] @ head[i] for i in range(m)]
