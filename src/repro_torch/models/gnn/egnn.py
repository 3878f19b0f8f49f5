"""E(n)-equivariant GNN (Satorras et al. 2021; ``repro.models.gnn.egnn``),
the exact EGNN layer:

    m_ij  = phi_e(h_i, h_j, ||x_i - x_j||^2)
    x_i'  = x_i + C * sum_j (x_i - x_j) * phi_x(m_ij)
    h_i'  = phi_h(h_i, sum_j m_ij)

Rotating and translating the inputs rotates and translates x' and leaves
h' as it is (tested).  Parameters are ``{"embed", "layers": [{"phi_e",
"phi_x", "phi_h"}, ...], "readout"}``, each an `mlp_init` dict.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import mlp_apply, mlp_init, tree_map
from repro_torch.models.gnn.mpnn import gather_src
from repro_torch.sparse.segment import segment_mean, segment_sum


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_feat: int = 16
    coord_agg: str = "mean"      # paper uses C = 1/(n-1); mean is the stable form


def init_egnn(gen: torch.Generator, cfg: EGNNConfig, device=None) -> dict:
    """The reference's shapes and scales, drawn on ``gen``'s device and
    moved to ``device`` (``cuda`` unless told otherwise)."""
    dev = resolve_device(device)
    d = cfg.d_hidden
    params = {
        "embed": mlp_init(gen, [cfg.d_feat, d]),
        "layers": [{"phi_e": mlp_init(gen, [2 * d + 1, d, d]),
                    "phi_x": mlp_init(gen, [d, d, 1]),
                    "phi_h": mlp_init(gen, [2 * d, d, d])}
                   for _ in range(cfg.n_layers)],
        "readout": mlp_init(gen, [d, d, 1]),
    }
    return tree_map(lambda t: t.to(dev), params)


def forward_edges(params, cfg: EGNNConfig, node_feats, pos, edge_src,
                  edge_dst, n_nodes: int):
    """-> (h (N, d), pos' (N, 3), energy ())."""
    h = mlp_apply(params["embed"], node_feats)
    x = pos
    agg_fn = segment_mean if cfg.coord_agg == "mean" else segment_sum
    for p in params["layers"]:
        xi, xj = gather_src(x, edge_dst), gather_src(x, edge_src)
        diff = xi - xj
        dist2 = torch.sum(diff * diff, dim=-1, keepdim=True)
        hi, hj = gather_src(h, edge_dst), gather_src(h, edge_src)
        m = mlp_apply(p["phi_e"], torch.cat([hi, hj, dist2], -1),
                      final_act=True)
        coef = mlp_apply(p["phi_x"], m)                      # (E, 1)
        x = x + agg_fn(diff * coef, edge_dst, n_nodes)
        m_agg = segment_sum(m, edge_dst, n_nodes)
        h = h + mlp_apply(p["phi_h"], torch.cat([h, m_agg], -1))
    energy = mlp_apply(params["readout"], h).sum()
    return h, x, energy


def loss_edges(params, cfg: EGNNConfig, node_feats, pos, edge_src, edge_dst,
               target_pos, n_nodes: int):
    _, x, _ = forward_edges(params, cfg, node_feats, pos, edge_src,
                            edge_dst, n_nodes)
    return torch.mean(torch.square(x - target_pos))
