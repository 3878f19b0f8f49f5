from repro_torch.graphs.csr import Graph, build_graph
from repro_torch.graphs.generators import rmat_graph
from repro_torch.graphs.datasets import SNAP_STATS, synthetic_snap, scaled_snap

__all__ = [
    "Graph",
    "build_graph",
    "rmat_graph",
    "SNAP_STATS",
    "synthetic_snap",
    "scaled_snap",
]
