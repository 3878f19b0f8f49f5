from repro_torch.graphs.csr import Graph, build_graph
from repro_torch.graphs.generators import (
    erdos_graph, path_graph, rmat_graph, star_graph,
)
from repro_torch.graphs.datasets import SNAP_STATS, synthetic_snap, scaled_snap

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
]
