"""hymba-1.5b — parallel attention + mamba heads [arXiv:2411.13676]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, sliding_window=1024, head_dim=64,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", family="hybrid",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=257, ssm_state=8, sliding_window=32,
        dtype="float32", param_dtype="float32",
    )
