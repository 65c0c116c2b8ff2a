"""``--arch`` registry: maps architecture ids to configs (the port's copy
of ``repro.configs.registry``).

The id list is the reference's, so an unknown id and a known but not yet
ported one fail with different messages; the port has the config modules
of every assigned arch -- the dense family, xlstm-1.3b (ssm), hymba-1.5b
(hybrid), the moe family (olmoe-1b-7b, qwen3-moe-30b-a3b), internvl2-26b
(vlm) and whisper-small (audio) -- and of the paper's four evaluation
models (cnn and encoder).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

ASSIGNED = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "hymba-1.5b": "hymba_1_5b",
    "xlstm-1.3b": "xlstm_1_3b",
    "internvl2-26b": "internvl2_26b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "deepseek-67b": "deepseek_67b",
    "whisper-small": "whisper_small",
    "granite-3-2b": "granite_3_2b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
}

PAPER_MODELS = {
    "resnet50": "resnet50",
    "resnext50": "resnext50",
    "bert-base": "bert_base",
    "xlnet-base": "xlnet_base",
}

ALL = {**ASSIGNED, **PAPER_MODELS}

# the archs whose config modules (and model family) the port has
PORTED = ("tinyllama-1.1b", "deepseek-67b", "granite-3-2b", "qwen1.5-0.5b",
          "xlstm-1.3b", "hymba-1.5b", "olmoe-1b-7b", "qwen3-moe-30b-a3b", "internvl2-26b",
          "whisper-small", *PAPER_MODELS)

LONG_CONTEXT_WINDOW = 8192


def _module(arch: str):
    if arch not in ALL:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALL)}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet; ported: {list(PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{ALL[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def supported(arch: str, shape: ShapeConfig | str) -> bool:
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = get_config(arch)
    if cfg.family in ("cnn", "encoder"):
        return False
    if shape.name == "long_500k" and cfg.family == "audio":
        return False
    return True


def config_for_shape(arch: str, shape: ShapeConfig | str, *, num_instances: int = 1) -> ModelConfig:
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = get_config(arch)
    if not supported(arch, shape):
        raise ValueError(f"{arch} does not run shape {shape.name}")
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm"):
        cfg = cfg.with_(sliding_window=LONG_CONTEXT_WINDOW)
    if shape.kind in ("prefill", "decode"):
        # inference deployments carry bf16 weights
        cfg = cfg.with_(param_dtype="bfloat16")
    if num_instances != 1:
        cfg = cfg.with_(num_instances=num_instances)
    return cfg
