"""Shared model building blocks (``repro.models.common``): plain dicts of
tensors, no framework."""
from __future__ import annotations

import math

import torch

from repro_torch.sparse.segment import stable_segment_sum


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


def take_index(idx: torch.Tensor, n: int):
    """``(safe, invalid)`` for gathering from ``n`` rows as ``jnp.take``
    does by default (mode ``fill``): an index in ``[-n, 0)`` wraps, any
    other index outside ``[0, n)`` gives a NaN row.  ``safe`` is the index
    modulo ``n`` (the wrap, and some row in range for an invalid index),
    ``invalid`` where it lay outside ``[-n, n)``.  No host sync, so a bad
    id never reaches the device as an out-of-range index (on CUDA that is
    a device-side assert that ends the process's CUDA context)."""
    idx = idx.to(torch.int64)
    inside = idx.clamp(-n, n - 1)
    return torch.remainder(inside, n), inside != idx


class GatherRows(torch.autograd.Function):
    """``table.index_select(0, idx)`` whose gradient sums the rows of a
    repeated index with `stable_segment_sum`: the same bits on every run,
    where ``index_select``'s own backward (``index_add_``) sums them with
    atomics on the card.  The forward is ``index_select``'s."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        return stable_segment_sum(grad, idx, ctx.rows), None


def take_rows(table: torch.Tensor, safe: torch.Tensor,
              invalid: torch.Tensor, *, stable_grad: bool = False
              ) -> torch.Tensor:
    """``table``'s rows at `take_index`'s ``safe``, NaN where ``invalid``:
    ``(*safe.shape, *table.shape[1:])``.  The gradient of a NaN row reaches
    no row of ``table``, as ``jax.grad`` through the fill mode drops it.
    With ``stable_grad`` the gradient is `GatherRows`'s, the same bits on
    every run (a training replay needs them)."""
    flat = safe.reshape(-1)
    rows = (GatherRows.apply(table, flat) if stable_grad
            else table.index_select(0, flat)).view(
        *safe.shape, *table.shape[1:])
    mask = invalid.view(*invalid.shape, *(1,) * (table.dim() - 1))
    return rows.masked_fill(mask, float("nan"))
