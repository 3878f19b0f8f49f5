"""Synthetic node features and labels for the GNN examples
(``repro.data.graph_feats``), numpy, bitwise the reference's.

Features carry signal about a hidden community assignment (planted
partition): feature = one-hot(community) @ mixing + noise; the label is the
community, so a 2-layer GNN can learn it through neighborhood smoothing.
"""
from __future__ import annotations

import numpy as np


def synthetic_node_features(n_nodes: int, d_feat: int, n_classes: int,
                            *, seed: int = 0, noise: float = 1.0):
    """``(feats (n_nodes, d_feat) float32, labels (n_nodes,) int32)``."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_classes, size=n_nodes)
    mixing = rng.normal(0, 1.0, size=(n_classes, d_feat))
    feats = mixing[comm] + rng.normal(0, noise, size=(n_nodes, d_feat))
    return feats.astype(np.float32), comm.astype(np.int32)
