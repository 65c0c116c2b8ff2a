"""granite-3-2b — dense GQA [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=49155,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke", family="dense",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=257,
        dtype="float32", param_dtype="float32",
    )
