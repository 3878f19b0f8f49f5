"""Scatter patterns of the IMM counters (``repro.sparse.scatter``).

``bincount_weighted`` is the vertex-occurrence counter of Algorithm 2
(EfficientIMM Find_Most_Influential_Set): every RRR set adds its weight
into the counter of each member vertex.  Index lists pad with the
sentinel id ``num_buckets``, which is dropped.  Plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.sparse.segment import segment_sum


def _scatter(target, idx, updates, reduce: str):
    """``target.at[idx].<reduce>(updates, mode="drop")`` out of place:
    negative ids wrap once, as NumPy indexing does, and ids still outside
    ``[0, len)`` land in a spare row past the end, which is cut off."""
    n = target.shape[0]
    idx = torch.as_tensor(idx, device=target.device).long()
    idx = torch.where(idx < 0, idx + n, idx)
    idx = torch.where((idx >= 0) & (idx < n), idx, n).reshape(-1)
    tail = tuple(target.shape[1:])
    upd = torch.as_tensor(updates, dtype=target.dtype,
                          device=target.device).broadcast_to(
        tuple(idx.shape) + tail).reshape((-1,) + tail)
    buf = torch.cat([target, target.new_zeros((1,) + tail)])
    if reduce == "add":
        buf.index_add_(0, idx, upd)
    else:
        pos = idx.reshape((-1,) + (1,) * len(tail)).expand_as(upd)
        buf.scatter_reduce_(0, pos, upd, "amax", include_self=True)
    return buf[:n]


def scatter_add(target, idx, updates):
    """``target.at[idx].add(updates, mode="drop")``, out of place."""
    return _scatter(target, idx, updates, "add")


def scatter_or(target, idx, updates):
    """``target.at[idx].max(updates, mode="drop")``, out of place."""
    return _scatter(target, idx, updates, "max")


def bincount_weighted(idx, weights, num_buckets: int):
    """Weighted histogram: ``out[b] = sum_i weights[i] * [idx[i] == b]``
    in the weights' dtype; ``idx`` may hold the sentinel
    ``num_buckets`` (dropped) and any shape, ``weights`` broadcasts
    against it."""
    flat_w = torch.as_tensor(weights, device=idx.device).broadcast_to(
        idx.shape).reshape(-1)
    return segment_sum(flat_w, idx.reshape(-1), num_buckets)


def one_hot_matmul_count(idx, weights, num_buckets: int,
                         dtype=torch.float32):
    """`bincount_weighted` as a one-hot contraction (the reference's
    dense-friendly counter), ``(..., ) -> (num_buckets,)``."""
    onehot = (idx[..., None] == torch.arange(
        num_buckets, dtype=idx.dtype, device=idx.device)).to(dtype)
    w = torch.as_tensor(weights, device=idx.device).broadcast_to(
        idx.shape).to(dtype)
    return torch.einsum("...n,...->n", onehot, w)
