"""Shared model building blocks (``repro.models.common``): plain dicts of
tensors, no framework.

The reference's ``shard_rows``/``shard_latent`` are GSPMD layout hints
(``with_sharding_constraint``) that do nothing on one device; they have
no function here.  The GNN configs keep their ``node_axes``,
``edge_axes`` and ``channel_axis`` fields, so that they compare field for
field with the reference's; placing those latents on the port's
`repro_torch.mesh.Mesh` belongs to the launchers' shardings (ROADMAP
A9d, ``launch/shardings``)."""
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


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis, computed in f32 and cast back to x's
    dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def dense_init(gen: torch.Generator, fan_in: int, fan_out: int,
               dtype=torch.float32, scale: float | None = None, *,
               lead: tuple = ()) -> torch.Tensor:
    """``normal(lead + (fan_in, fan_out)) * scale`` (``1/sqrt(fan_in)`` by
    default), drawn in f32 on ``gen``'s device and cast to ``dtype``."""
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn((*lead, fan_in, fan_out), generator=gen,
                    device=gen.device, dtype=torch.float32)
    return w.mul_(s).to(dtype)


def mlp_init(gen: torch.Generator, dims, dtype=torch.float32) -> dict:
    """``dims = [in, hidden, ..., out]`` -> ``{"w0", "b0", "w1", "b1",
    ...}``: `dense_init` weights, zero biases, on ``gen``'s device."""
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = dense_init(gen, a, b, dtype)
        params[f"b{i}"] = torch.zeros((b,), dtype=dtype, device=gen.device)
    return params


def mlp_apply(params: dict, x: torch.Tensor,
              act=torch.nn.functional.silu, final_act: bool = False):
    """``x @ w0 + b0``, ``act``, ... through every layer of ``params``; the
    last layer's output passes through ``act`` only with ``final_act``."""
    n = sum(1 for k in params if k.startswith("w"))
    for i in range(n):
        # promote as ``jnp.matmul`` does (bf16 latents, f32 weights)
        w = params[f"w{i}"]
        dt = torch.promote_types(x.dtype, w.dtype)
        x = x.to(dt) @ w.to(dt) + params[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def tree_leaves(tree) -> list:
    """The tensor leaves of nested dicts and lists, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` over the tensor leaves of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def stack_layers(layers: list) -> dict:
    """Per-layer parameter trees stacked on a leading L axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([p[k] for p in layers]) for k in first}
    return torch.stack(layers)


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views of the stacked leaves."""
    return tree_map(lambda t: t[i], layers)


def count_params(params) -> int:
    """The number of elements of every leaf of ``params``."""
    return sum(t.numel() for t in tree_leaves(params))


def value_and_grad(loss_fn, params, *args, **kwargs):
    """``(loss, grads)`` of ``loss_fn(params, *args, **kwargs)`` with
    grads a tree like ``params``: the counterpart of
    ``jax.value_and_grad(loss_fn)``, a leaf the loss does not reach
    getting zeros.  ``params`` is left as it is (its leaves are
    differentiated through detached aliases)."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = loss_fn(leaves, *args, **kwargs)
    flat = tree_leaves(leaves)
    grads = iter([torch.zeros_like(t) if g is None else g for t, g in zip(
        flat, torch.autograd.grad(loss, flat, allow_unused=True))])
    return loss.detach(), tree_map(lambda _: next(grads), leaves)


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
