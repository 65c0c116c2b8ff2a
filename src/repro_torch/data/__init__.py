from repro_torch.data.pipeline import (
    MemmapLM, SyntheticLM, make_audio_batch, make_batch, make_vlm_batch, write_token_file,
)
