"""egnn: E(n)-equivariant GNN (Satorras et al. 2021; ``repro.configs.egnn``).

[arXiv:2102.09844; paper]: assigned config n_layers=4 d_hidden=64,
equivariance=E(n).
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.configs._gnn_common import gnn_shapes, grad_norm
from repro_torch.configs.base import ArchDef, register
from repro_torch.models.common import value_and_grad
from repro_torch.models.gnn.egnn import (
    EGNNConfig, forward_edges, init_egnn, loss_edges,
)

FULL = EGNNConfig(n_layers=4, d_hidden=64)

SMOKE = EGNNConfig(n_layers=2, d_hidden=16, d_feat=8)


def _smoke_step(params, cfg: EGNNConfig, key) -> dict:
    """The reference's smoke step on ``params``' device (see
    ``graphsage_reddit._smoke_step``), with the gradients as ``grads``."""
    dev = params["readout"]["w0"].device
    n, e = 16, 48
    k1, k2, k3, k4 = prng.split(key, 4)
    nf = prng.normal(k1, (n, cfg.d_feat), device=dev)
    pos = prng.normal(k2, (n, 3), device=dev)
    es = prng.randint(k3, (e,), 0, n, device=dev)
    ed = prng.randint(k4, (e,), 0, n, device=dev)
    with torch.no_grad():
        h, x, energy = forward_edges(params, cfg, nf, pos, es, ed, n)
    loss, grads = value_and_grad(loss_edges, params, cfg, nf, pos, es, ed,
                                 pos, n)
    return {"h": h, "x": x, "energy": energy, "loss": loss,
            "grad_norm": grad_norm(grads), "grads": grads}


ARCH = register(ArchDef(
    arch_id="egnn",
    family="gnn",
    source="arXiv:2102.09844",
    config=FULL,
    smoke_config=SMOKE,
    shapes=gnn_shapes(),
    init_fn=init_egnn,
    smoke_step=_smoke_step,
    technique_applicable=True,
    technique_note="direct: message passing = gather -> segment reduce",
))
