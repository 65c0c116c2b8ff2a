"""ResNet-50 — the paper's own CNN eval model [He et al. 2016]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="resnet50", family="cnn",
    num_layers=16, d_model=0, num_heads=0, num_kv_heads=0, d_ff=0,
    vocab_size=0, cnn_stage_blocks=(3, 4, 6, 3), cnn_width=64,
    cnn_cardinality=1, image_size=224, num_classes=1000,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="resnet-smoke", family="cnn",
        num_layers=0, d_model=0, num_heads=0, num_kv_heads=0, d_ff=0,
        vocab_size=0, cnn_stage_blocks=(1, 1), cnn_width=8,
        cnn_cardinality=1, image_size=32, num_classes=10,
        dtype="float32", param_dtype="float32",
    )
