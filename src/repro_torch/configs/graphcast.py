"""graphcast: encode-process-decode mesh GNN (DeepMind GraphCast;
``repro.configs.graphcast``).

[arXiv:2212.12794; unverified]: assigned config n_layers=16 d_hidden=512
mesh_refinement=6 aggregator=sum n_vars=227.

On the assigned generic graph shapes the processor runs over the given
edge list; the icosahedral multi-mesh (refinement 6) defines the edge list
in the weather deployment.  The encoder input width follows each shape's
``d_feat`` (falling back to n_vars=227 where the shape does not fix one).
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.configs._gnn_common import gnn_shapes, grad_norm
from repro_torch.configs.base import ArchDef, register
from repro_torch.models.common import value_and_grad
from repro_torch.models.gnn.graphcast import (
    GraphCastConfig, forward_edges, init_graphcast, loss_edges,
)

FULL = GraphCastConfig(
    n_layers=16, d_hidden=512, mesh_refinement=6, aggregator="sum",
    n_vars=227, d_edge_in=4,
)

SMOKE = GraphCastConfig(
    n_layers=2, d_hidden=32, mesh_refinement=1, aggregator="sum",
    n_vars=11, d_edge_in=4, remat=False,
)


def _smoke_step(params, cfg: GraphCastConfig, key) -> dict:
    """The reference's smoke step on ``params``' device (see
    ``graphsage_reddit._smoke_step``), with the gradients as ``grads``."""
    dev = params["dec"]["w0"].device
    n, e = 24, 80
    k1, k2, k3, k4 = prng.split(key, 4)
    nf = prng.normal(k1, (n, cfg.n_vars), device=dev)
    ef = prng.normal(k2, (e, cfg.d_edge_in), device=dev)
    es = prng.randint(k3, (e,), 0, n, device=dev)
    ed = prng.randint(k4, (e,), 0, n, device=dev)
    with torch.no_grad():
        out = forward_edges(params, cfg, nf, ef, es, ed, n)
    loss, grads = value_and_grad(loss_edges, params, cfg, nf, ef, es, ed,
                                 nf, n)
    return {"out": out, "loss": loss, "grad_norm": grad_norm(grads),
            "grads": grads}


ARCH = register(ArchDef(
    arch_id="graphcast",
    family="gnn",
    source="arXiv:2212.12794",
    config=FULL,
    smoke_config=SMOKE,
    shapes=gnn_shapes(),
    init_fn=init_graphcast,
    smoke_step=_smoke_step,
    technique_applicable=True,
    technique_note=("direct: edge update + sum-aggregate = gather ->"
                    " segment_sum, the EfficientIMM counter pattern;"
                    " dst-block edge partitioning = paper C2"),
))
