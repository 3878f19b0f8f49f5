from repro_torch.graphs.csr import Graph, build_graph
from repro_torch.graphs.generators import (
    erdos_graph, path_graph, rmat_graph, star_graph,
)
from repro_torch.graphs.sampler import neighbor_sampler, sample_blocks
from repro_torch.graphs.datasets import SNAP_STATS, synthetic_snap, scaled_snap
from repro_torch.graphs.partition import (
    VertexPartition,
    balance_report,
    balanced_vertex_partition,
    partition_edges_by_dst,
    resolve_partition,
    vertex_partition,
)

__all__ = [
    "Graph",
    "build_graph",
    "rmat_graph",
    "erdos_graph",
    "star_graph",
    "path_graph",
    "SNAP_STATS",
    "synthetic_snap",
    "scaled_snap",
    "VertexPartition",
    "balance_report",
    "balanced_vertex_partition",
    "partition_edges_by_dst",
    "resolve_partition",
    "vertex_partition",
    "neighbor_sampler",
    "sample_blocks",
]
