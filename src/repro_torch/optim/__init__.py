from repro_torch.optim.adamw import (
    OptState, adamw_init, adamw_update, clip_by_global_norm, global_norm, sgdm_init,
    sgdm_update,
)
from repro_torch.optim.schedules import constant, cosine_with_warmup, linear_warmup
