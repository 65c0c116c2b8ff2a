"""deepseek-67b — llama-arch dense [arXiv:2401.02954]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=102400,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", family="dense",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=257,
        dtype="float32", param_dtype="float32",
    )
