"""equiformer-v2: SO(2)-eSCN equivariant graph attention
(``repro.configs.equiformer_v2``).

[arXiv:2306.12059; unverified]: assigned config n_layers=12 d_hidden=128
l_max=6 m_max=2 n_heads=8 equivariance=SO(2)-eSCN.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.configs._gnn_common import gnn_shapes, grad_norm
from repro_torch.configs.base import ArchDef, register
from repro_torch.models.common import value_and_grad
from repro_torch.models.gnn.equiformer import (
    EquiformerConfig, forward_edges, init_equiformer, loss_edges,
)

FULL = EquiformerConfig(
    n_layers=12, d_hidden=128, l_max=6, m_max=2, n_heads=8,
)

SMOKE = EquiformerConfig(
    n_layers=2, d_hidden=16, l_max=2, m_max=1, n_heads=2, d_feat=8,
    remat=False,
)


def _smoke_step(params, cfg: EquiformerConfig, key) -> dict:
    """The reference's smoke step on ``params``' device (see
    ``graphsage_reddit._smoke_step``), with the gradients as ``grads``."""
    dev = params["out"]["w0"].device
    n, e = 16, 48
    k1, k2, k3, k4 = prng.split(key, 4)
    nf = prng.normal(k1, (n, cfg.d_feat), device=dev)
    pos = prng.normal(k2, (n, 3), device=dev)
    es = prng.randint(k3, (e,), 0, n, device=dev)
    ed = prng.randint(k4, (e,), 0, n, device=dev)
    with torch.no_grad():
        inv, out = forward_edges(params, cfg, nf, pos, es, ed, n)
    targets = torch.zeros((n, cfg.n_out), device=dev)
    loss, grads = value_and_grad(loss_edges, params, cfg, nf, pos, es, ed,
                                 targets, n)
    return {"inv": inv, "out": out, "loss": loss,
            "grad_norm": grad_norm(grads), "grads": grads}


ARCH = register(ArchDef(
    arch_id="equiformer-v2",
    family="gnn",
    source="arXiv:2306.12059",
    config=FULL,
    smoke_config=SMOKE,
    shapes=gnn_shapes(),
    init_fn=init_equiformer,
    smoke_step=_smoke_step,
    technique_applicable=True,
    technique_note=("direct: irrep message aggregation is gather ->"
                    " segment_sum over edges; the eSCN SO(2)"
                    " trick replaces the O(L^6) CG tensor product"),
))
