"""Gradient compression: int8 quantization with error feedback
(``repro.runtime.compression``).

Each leaf is quantized to int8 with a per-leaf max-abs scale, and the
quantization residual is carried into the next step (error feedback,
which keeps SGD and Adam converging).  An all-reduce of the int8 leaves
moves a quarter of the float32 bytes.  As in the reference, no train step
calls these functions.

The arithmetic is the reference's, operation for operation: the scale is
``max|x| / 127`` in float32, floored at float32's nearest value to 1e-30,
and ``torch.round`` rounds half to even as ``jnp.round`` does, so ``q``,
``scale`` and the residuals are bitwise the JAX package's, and bitwise
the same on the card and on the host.  Trees are nested dicts, lists and
tuples of tensors.
"""
from __future__ import annotations

import dataclasses

import torch


def compress_int8(x: torch.Tensor):
    """-> ``(q int8, scale float32 ())`` with symmetric max-abs scaling."""
    xf = x.to(torch.float32)
    # a divisor on the card: CUDA divides by a host scalar through its
    # reciprocal, one ulp off the quotient
    amax = xf.abs().max()
    scale = torch.clamp(amax / torch.full((), 127.0, device=amax.device),
                        min=1e-30)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


@dataclasses.dataclass
class ErrorFeedbackState:
    residual: dict


def _leaves(tree):
    """The tensor leaves of nested dicts (in sorted key order, as
    ``jax.tree.leaves`` walks them), lists and tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken from ``it`` in order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, it) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return next(it)


def init_error_feedback(grads) -> dict:
    return {"residual": _rebuild(grads, iter(
        torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for g in _leaves(grads)))}


def compress_with_feedback(grads, ef_state: dict):
    """Quantize ``grad + residual``; the new residual is that input less
    its dequantized value.  -> ``(tree of (q, scale) pairs, new
    ef_state)``."""
    pairs, residual = [], []
    for g, r in zip(_leaves(grads), _leaves(ef_state["residual"])):
        x = g.to(torch.float32) + r
        q, s = compress_int8(x)
        pairs.append((q, s))
        residual.append(x - decompress_int8(q, s))
    return (_rebuild(grads, iter(pairs)),
            {"residual": _rebuild(grads, iter(residual))})


def compressed_allreduce_spec(grads_bytes_f32: int) -> dict:
    """The collective's bytes at float32 and at int8."""
    return {
        "fp32_bytes": grads_bytes_f32,
        "int8_bytes": grads_bytes_f32 // 4,
        "saving": 4.0,
    }
