"""GraphSAGE (Hamilton et al. 2017; ``repro.models.gnn.graphsage``): mean
aggregator, 2 layers, minibatch fan-out sampling (sample_sizes 25-10 in
the assigned config).

Two apply modes:
  * `forward_blocks`: the native minibatch form over sampled neighbour
    blocks (the reddit ``minibatch_lg`` cell);
  * `forward_edges`: the full-graph form over an edge list.

Parameters are ``{"layers": [{"w_self", "w_nbr", "b"}, ...], "w_out"}``,
the reference's tree.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import dense_init
from repro_torch.models.gnn.mpnn import aggregate, gather_src


@dataclasses.dataclass(frozen=True)
class SageConfig:
    name: str = "graphsage"
    n_layers: int = 2
    d_hidden: int = 128
    d_feat: int = 602
    n_classes: int = 41
    aggregator: str = "mean"
    sample_sizes: tuple = (25, 10)


def init_sage(gen: torch.Generator, cfg: SageConfig, device=None) -> dict:
    """The reference's shapes and scales (``N(0, 1/fan_in)`` weights,
    zero biases), drawn on ``gen``'s device and moved to ``device``
    (``cuda`` unless told otherwise; without a GPU that raises unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    dims = [cfg.d_feat] + [cfg.d_hidden] * cfg.n_layers
    layers = [{
        "w_self": dense_init(gen, dims[i], dims[i + 1]).to(dev),
        "w_nbr": dense_init(gen, dims[i], dims[i + 1]).to(dev),
        "b": torch.zeros((dims[i + 1],), device=dev),
    } for i in range(cfg.n_layers)]
    return {"layers": layers,
            "w_out": dense_init(gen, cfg.d_hidden, cfg.n_classes).to(dev)}


def _sage_layer(p, h_self, h_nbr_mean):
    return torch.relu(h_self @ p["w_self"] + h_nbr_mean @ p["w_nbr"]
                      + p["b"])


def forward_blocks(params, cfg: SageConfig, x_seed, x_n1, x_n2):
    """x_seed (B, F); x_n1 (B, f1, F); x_n2 (B*f1, f2, F) -> logits (B, C).
    The means run over the whole fan-out, sentinel rows included."""
    B, f1, F = x_n1.shape
    l1, l2 = params["layers"][0], params["layers"][1]
    # layer-1 embeddings for seeds and their level-1 neighbours
    h1_seed = _sage_layer(l1, x_seed, x_n1.mean(dim=1))
    h1_n1 = _sage_layer(l1, x_n1.reshape(B * f1, F), x_n2.mean(dim=1))
    # layer 2 for seeds
    h2 = _sage_layer(l2, h1_seed, h1_n1.reshape(B, f1, -1).mean(dim=1))
    return h2 @ params["w_out"]


def forward_edges(params, cfg: SageConfig, node_feats, edge_src, edge_dst,
                  n_nodes: int):
    """Full-graph mode: logits for every node."""
    h = node_feats
    for p in params["layers"]:
        agg = aggregate(gather_src(h, edge_src), edge_dst, n_nodes,
                        cfg.aggregator)
        h = _sage_layer(p, h, agg)
    return h @ params["w_out"]


def _nll(logits, labels):
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None]).mean()


def loss_blocks(params, cfg: SageConfig, x_seed, x_n1, x_n2, labels):
    return _nll(forward_blocks(params, cfg, x_seed, x_n1, x_n2), labels)


def loss_edges(params, cfg: SageConfig, node_feats, edge_src, edge_dst,
               labels, n_nodes: int):
    return _nll(forward_edges(params, cfg, node_feats, edge_src, edge_dst,
                              n_nodes), labels)
