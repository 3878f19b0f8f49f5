"""Global-norm gradient clipping (``repro.optim.clip``)."""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_map


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def global_norm_scale(grads, max_norm: float):
    """``(scale, norm)``: the gradients' global norm and ``scale = min(1,
    max_norm / max(norm, 1e-9))``.  Each leaf is squared in its own dtype
    and summed in float32, as in the reference (bf16 keeps f32's exponent
    range, so nothing overflows, and no f32 copy of a bf16 leaf is
    made)."""
    total = torch.sqrt(sum(torch.sum(torch.square(g), dtype=torch.float32)
                           for g in _leaves(grads)))
    return torch.clamp(max_norm / torch.clamp(total, min=1e-9),
                       max=1.0), total


def clip_by_global_norm(grads, max_norm: float):
    """``(grads * scale, norm)`` of `global_norm_scale`, each leaf scaled
    in its own dtype."""
    scale, total = global_norm_scale(grads, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), total
