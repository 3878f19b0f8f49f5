"""Optimizers and schedules (``repro.optim``): plain functions over dicts
of tensors, the reference's pytrees, with no ``torch.optim``."""
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_init, adamw_update, adamw_update_,
)
from repro_torch.optim.clip import clip_by_global_norm, global_norm_scale
from repro_torch.optim.schedule import (
    cosine_schedule, linear_warmup, wsd_schedule,
)

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "adamw_update_",
    "wsd_schedule", "cosine_schedule", "linear_warmup",
    "clip_by_global_norm", "global_norm_scale",
]
