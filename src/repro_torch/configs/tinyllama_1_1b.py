"""tinyllama-1.1b — llama2-arch small [arXiv:2401.02385]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=5632, vocab_size=32000,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-smoke", family="dense",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=257,
        dtype="float32", param_dtype="float32",
    )
