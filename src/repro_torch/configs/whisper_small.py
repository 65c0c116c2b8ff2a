"""whisper-small -- enc-dec, conv frontend stubbed [arXiv:2212.04356].

As in the reference, the caller supplies post-conv frame embeddings
(1500 x d_model): the mel spectrogram and the conv front end are a stub,
and serving feeds zero frames.  The decoder's learned positions reach
33024, past the published 448, as the reference extends them.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    encoder_layers=12, num_audio_frames=1500, max_target_positions=33024,
    use_layernorm=True, act="gelu",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=257, encoder_layers=2, num_audio_frames=16,
        max_target_positions=128, use_layernorm=True, act="gelu",
        dtype="float32", param_dtype="float32",
    )
