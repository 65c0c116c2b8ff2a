"""Model/config schema (the port's copy of ``repro.configs.base``).

``ModelConfig`` carries every field of the reference schema except
``use_pallas_kernels``: in the port the device of the tensors decides
whether a kernel or its plain version runs.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio", "cnn", "encoder"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    # --- SSM / xLSTM / Mamba ---
    ssm_state: int = 0
    conv_kernel: int = 4
    slstm_every: int = 0
    slstm_offset: int = 3
    mlstm_proj_factor: float = 2.0
    mlstm_chunk: int = 64
    # --- attention ---
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0           # 0 = full attention
    global_layer_every: int = 0
    # --- norm / misc ---
    norm_eps: float = 1e-5
    use_layernorm: bool = False
    tie_embeddings: bool = False
    act: str = "silu"
    # --- enc-dec / multimodal stubs ---
    encoder_layers: int = 0
    num_audio_frames: int = 0
    num_image_patches: int = 0
    vision_embed_dim: int = 0
    max_target_positions: int = 0
    # --- cnn ---
    cnn_stage_blocks: tuple[int, ...] = ()
    cnn_width: int = 64
    cnn_cardinality: int = 1
    image_size: int = 224
    num_classes: int = 1000
    # --- NetFuse ---
    num_instances: int = 1            # M merged fine-tuned instances
    # --- numerics ---
    dtype: str = "bfloat16"           # activations and stored layer weights
    param_dtype: str = "float32"      # embed, lm_head and norm scales
    remat: bool = True

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def q_heads_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES: dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}
