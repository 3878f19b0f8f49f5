"""Sparse and ragged primitives (``repro.sparse``): segment reductions
and the IMM counters' scatters.  The embedding bags wait for the sharded
FM lookup (ROADMAP A9c)."""
from repro_torch.sparse.scatter import (
    bincount_weighted,
    one_hot_matmul_count,
    scatter_add,
    scatter_or,
)
from repro_torch.sparse.segment import (
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
    sorted_segment_sum,
)

__all__ = [
    "segment_sum", "segment_max", "segment_mean", "segment_softmax",
    "sorted_segment_sum", "scatter_add", "scatter_or", "bincount_weighted",
    "one_hot_matmul_count",
]
