"""XLNet-base (Transformer-XL rel-attention) — paper eval model
[Yang et al. 2019]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlnet-base", family="encoder",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=32000, max_target_positions=512,
    use_layernorm=True, act="gelu",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlnet-smoke", family="encoder",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=257, max_target_positions=128,
        use_layernorm=True, act="gelu",
        dtype="float32", param_dtype="float32",
    )
