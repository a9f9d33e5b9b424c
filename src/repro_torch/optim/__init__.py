# AdamW as the reference implements it (not torch.optim.AdamW).
from repro_torch.optim.adamw import (AdamWState, adamw_init,  # noqa: F401
                                     adamw_update, clip_by_global_norm)
from repro_torch.optim.schedules import (cosine_schedule,  # noqa: F401
                                         cosine_schedule_t, linear_warmup)
