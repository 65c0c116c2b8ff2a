"""qwen1.5-0.5b — dense with QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=2816, vocab_size=151936, qkv_bias=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke", family="dense",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=257, qkv_bias=True,
        dtype="float32", param_dtype="float32",
    )
