"""The GNNs (``repro.models.gnn``): message passing (`mpnn`), GraphSAGE,
GraphCast, EGNN and Equiformer-v2 with its irreps.  Their hot operations
are the reference's XLA ops, here plain PyTorch (``index_select``
gathers, `repro_torch.sparse.segment` reductions, ``matmul`` and
batched products); no Pallas kernel lies on their path."""
from repro_torch.models.gnn import (
    egnn, equiformer, graphcast, graphsage, irreps, mpnn,
)

__all__ = ["mpnn", "graphsage", "graphcast", "egnn", "irreps", "equiformer"]
