"""xlstm-1.3b — sLSTM + mLSTM blocks, xLSTM[7:1] [arXiv:2405.04517].

The spec gives d_ff=0: xLSTM blocks have no separate FFN; mLSTM blocks
up-project by mlstm_proj_factor=2 internally and sLSTM blocks carry a
4/3-factor gated FFN (paper defaults).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    slstm_every=8, slstm_offset=3, mlstm_proj_factor=2.0,
    mlstm_chunk=128,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="ssm",
        num_layers=3, d_model=64, num_heads=2, num_kv_heads=2,
        d_ff=0, vocab_size=257, slstm_every=2, slstm_offset=1,
        dtype="float32", param_dtype="float32",
    )
