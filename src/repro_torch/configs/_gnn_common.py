"""Shared scaffolding of the four GNN architecture configs
(``repro.configs._gnn_common``).

All four GNN archs share the assigned shape set; their inputs differ
(graphcast needs edge features, egnn/equiformer need coordinates,
graphsage's ``minibatch_lg`` uses its native sampled-block form).

``minibatch_lg`` sizes follow the assignment: 1024 seed nodes with 15-10
fan-out.  For edge-list archs the sampled blocks are materialized as the
induced bipartite subgraph (hop edges only), the standard message-flow-
graph lowering of neighbour sampling.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ShapeDef
from repro_torch.models.common import tree_leaves


def gnn_shapes():
    return {
        "full_graph_sm": ShapeDef(
            "full_graph_sm", "train",
            {"n_nodes": 2_708, "n_edges": 10_556, "d_feat": 1_433,
             "n_classes": 7},
            note="cora-scale full-batch"),
        "minibatch_lg": ShapeDef(
            "minibatch_lg", "train",
            {"n_nodes": 232_965, "n_edges": 114_615_892,
             "batch_nodes": 1_024, "fanout": (15, 10),
             "d_feat": 602, "n_classes": 41},
            note="reddit-scale sampled training; per-step inputs are the"
                 " sampled blocks (1024 seeds x 15 x 10)"),
        "ogb_products": ShapeDef(
            "ogb_products", "train",
            {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100,
             "n_classes": 47},
            note="full-batch-large"),
        "molecule": ShapeDef(
            "molecule", "train",
            {"n_nodes": 30, "n_edges": 64, "batch": 128},
            note="batched small graphs as a disjoint union"
                 " (N=3840, E=8192)"),
    }


def minibatch_subgraph_dims(batch_nodes: int, fanout):
    """Node/edge counts of the sampled message-flow graph."""
    f1, f2 = fanout
    n_hop1 = batch_nodes * f1
    n_hop2 = n_hop1 * f2
    n_nodes = batch_nodes + n_hop1 + n_hop2
    n_edges = n_hop1 + n_hop2
    return n_nodes, n_edges


def grad_norm(grads) -> torch.Tensor:
    """The gradients' global norm, each leaf squared and summed in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(grads)))
