"""qwen3-moe-30b-a3b — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936,
    num_experts=128, num_experts_per_tok=8,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=64, vocab_size=257, num_experts=4, num_experts_per_tok=2,
        dtype="float32", param_dtype="float32",
    )
