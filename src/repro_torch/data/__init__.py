"""Synthetic data streams (``repro.data``): the token stream of the LMs
(`TokenPipeline`), the CTR click stream of the FM model, the GNNs'
planted-partition node features and a host-side `Prefetcher`."""
from repro_torch.data.tokens import synthetic_token_batches, TokenPipeline
from repro_torch.data.clicks import synthetic_click_batches
from repro_torch.data.graph_feats import synthetic_node_features
from repro_torch.data.prefetch import Prefetcher

__all__ = [
    "synthetic_token_batches",
    "TokenPipeline",
    "synthetic_click_batches",
    "synthetic_node_features",
    "Prefetcher",
]
