from repro_torch.optim.adamw import (  # noqa: F401
    OptConfig, init_opt_state, adamw_update, clip_by_global_norm,
    global_norm)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
