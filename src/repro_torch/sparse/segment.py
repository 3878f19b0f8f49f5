"""Segment reductions, the reduce-by-key primitive (``repro.sparse.segment``).

Rows of ``data`` are reduced into ``num_segments`` buckets keyed by
``segment_ids``; ids outside ``[0, num_segments)`` (the padding id
``num_segments`` among them) are dropped, as ``jax.ops.segment_*``
drops them: they land in one spare bucket past the end, which is cut
off, so no reduction waits on the host.  Plain PyTorch: ``index_add_``
and ``scatter_reduce_``; `stable_segment_sum` sorts instead, so that its
sums have the same bits on every run on the card too.
"""
from __future__ import annotations

import torch


def _ids(data, segment_ids, num_segments: int):
    """Flat ids with every out-of-range id sent to the spare bucket
    ``num_segments``."""
    ids = torch.as_tensor(segment_ids, device=data.device).reshape(-1)
    ok = (ids >= 0) & (ids < num_segments)
    return torch.where(ok, ids, num_segments).long()


def segment_sum(data, segment_ids, num_segments: int):
    """Sum ``data`` rows into ``num_segments`` buckets keyed by
    ``segment_ids``."""
    ids = _ids(data, segment_ids, num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids, data)[:num_segments]


def sorted_segment_sum(data, segment_ids, num_segments: int):
    """`segment_sum` for ids already sorted (the reference's hint)."""
    return segment_sum(data, segment_ids, num_segments)


def stable_segment_sum(data, segment_ids, num_segments: int):
    """`segment_sum` with the same bits on every run, on the card too.
    On CUDA ``index_add_`` adds a bucket's rows with atomics, in the order
    its threads happen to run; here the rows are stably sorted by id and
    each bucket's rows are summed in float32 in their original order, one
    thread a column (``torch.segment_reduce``), then cast to ``data``'s
    dtype once.  On the host and in float32 that is ``index_add_``'s
    order and bits.  Every id must lie in ``[0, num_segments)``; the
    bucket count is read on the host (one sync)."""
    ids = torch.as_tensor(segment_ids, device=data.device).reshape(-1).long()
    order = torch.argsort(ids, stable=True)
    uniq, counts = torch.unique_consecutive(ids[order], return_counts=True)
    sums = torch.segment_reduce(data.index_select(0, order).to(torch.float32),
                                "sum", lengths=counts, axis=0)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    out[uniq] = sums.to(data.dtype)
    return out


def _lowest(dtype):
    if dtype.is_floating_point:
        return -torch.inf
    return torch.iinfo(dtype).min


def segment_max(data, segment_ids, num_segments: int):
    """Per-segment max; an empty segment holds the dtype's lowest value
    (``-inf`` for floats), as in JAX."""
    ids = _ids(data, segment_ids, num_segments)
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]),
                     _lowest(data.dtype), dtype=data.dtype,
                     device=data.device)
    idx = ids.reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    return out.scatter_reduce_(0, idx, data, "amax",
                               include_self=True)[:num_segments]


def segment_mean(data, segment_ids, num_segments: int):
    total = segment_sum(data, segment_ids, num_segments)
    ones = torch.ones(data.shape[:1], dtype=total.dtype, device=data.device)
    count = segment_sum(ones, segment_ids, num_segments).clamp_min(1)
    if total.ndim > count.ndim:
        count = count.reshape(count.shape + (1,) * (total.ndim - count.ndim))
    return total / count


def segment_softmax(logits, segment_ids, num_segments: int):
    """Softmax over variable-length segments (GAT-style edge softmax)."""
    ids = torch.as_tensor(segment_ids, device=logits.device).long()
    seg_max = segment_max(logits, ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    # padding rows read a clamped bucket, as JAX's gather does (negative
    # ids wrap once first, as in NumPy indexing)
    gather = torch.where(ids < 0, ids + num_segments, ids).clamp(
        0, num_segments - 1)
    expd = torch.exp(logits - seg_max[gather])
    denom = segment_sum(expd, ids, num_segments).clamp_min(1e-30)
    return expd / denom[gather]
