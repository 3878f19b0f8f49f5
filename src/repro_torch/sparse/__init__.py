"""Sparse and ragged primitives (``repro.sparse``): segment reductions,
the IMM counters' scatters and the embedding bags (one device, and a
table row-sharded over a `repro_torch.mesh.Mesh`)."""
from repro_torch.sparse.embedding_bag import (
    embedding_bag,
    row_shards,
    sharded_embedding_lookup,
)
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
    "one_hot_matmul_count", "embedding_bag", "sharded_embedding_lookup",
    "row_shards",
]
