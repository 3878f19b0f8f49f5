"""LR schedules (``repro.optim.schedule``): float32 multipliers of the
peak rate for a step (an int or an integer tensor).  WSD
(warmup-stable-decay) is the MiniCPM schedule (arXiv:2404.06395)."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step, warmup: int) -> torch.Tensor:
    return torch.clamp(_f32(step) / max(warmup, 1), max=1.0)


def wsd_schedule(step, *, warmup: int, stable: int, decay: int,
                 final_frac: float = 0.1) -> torch.Tensor:
    """Warmup -> flat -> linear decay to ``final_frac``."""
    s = _f32(step)
    warm = s / max(warmup, 1)
    in_decay = torch.clamp((s - warmup - stable) / max(decay, 1), 0.0, 1.0)
    decay_mult = 1.0 - (1.0 - final_frac) * in_decay
    return torch.where(s < warmup, warm, decay_mult)


def cosine_schedule(step, *, warmup: int, total: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    s = _f32(step)
    warm = s / max(warmup, 1)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(s < warmup, warm, cos)
