"""internvl2-26b — InternViT (stub) + InternLM2 20B backbone [arXiv:2404.16821].

The vision encoder is a stub, as in the reference: the serving path
feeds zero patch embeddings (num_image_patches x vision_embed_dim, the
InternViT-6B hidden size); this config is the language decoder and the
MLP projector.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92553,
    num_image_patches=256, vision_embed_dim=3200,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=257, num_image_patches=8, vision_embed_dim=96,
        dtype="float32", param_dtype="float32",
    )
