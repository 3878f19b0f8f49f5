"""Shared model building blocks (``repro.models.common``): plain dicts of
tensors, no framework."""
from __future__ import annotations

import math

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis, computed in f32 and cast back to x's
    dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)).to(x.dtype)


def dense_init(gen: torch.Generator, fan_in: int, fan_out: int,
               dtype=torch.float32, scale: float | None = None, *,
               lead: tuple = ()) -> torch.Tensor:
    """``normal(lead + (fan_in, fan_out)) * scale`` (``1/sqrt(fan_in)`` by
    default), drawn in f32 on ``gen``'s device and cast to ``dtype``."""
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn((*lead, fan_in, fan_out), generator=gen,
                    device=gen.device, dtype=torch.float32)
    return w.mul_(s).to(dtype)
