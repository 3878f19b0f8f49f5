"""Synthetic data streams (``repro.data``): the CTR click stream of the FM
model.  Token, graph-feature and prefetch streams wait for their slices
(ROADMAP A9b, A9c)."""
from repro_torch.data.clicks import synthetic_click_batches

__all__ = ["synthetic_click_batches"]
