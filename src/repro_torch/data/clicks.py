"""Synthetic CTR click stream for the FM recsys arch
(``repro.data.clicks``, numpy, the same draws for the same arguments).

Ground-truth model: a hidden low-rank FM over the categorical fields; labels
are Bernoulli draws from its sigmoid. A learner with the same family can
recover it, so examples/recsys_ctr shows real AUC/loss improvement.
"""
from __future__ import annotations

import numpy as np


def synthetic_click_batches(n_fields: int, vocab_per_field: int, batch: int,
                            steps: int, *, dim: int = 4, seed: int = 0,
                            shard: int = 0):
    rng0 = np.random.default_rng(seed)
    # hidden FM parameters (shared across steps)
    v_true = rng0.normal(0, 0.3, size=(n_fields, vocab_per_field, dim))
    w_true = rng0.normal(0, 0.3, size=(n_fields, vocab_per_field))

    for step in range(steps):
        rng = np.random.default_rng((seed * 7919 + step) * 104_729 + shard)
        idx = rng.integers(0, vocab_per_field, size=(batch, n_fields))
        emb = v_true[np.arange(n_fields)[None, :], idx]      # (B, F, K)
        s = emb.sum(axis=1)
        s2 = (emb * emb).sum(axis=1)
        pair = 0.5 * (s * s - s2).sum(axis=-1)
        lin = w_true[np.arange(n_fields)[None, :], idx].sum(axis=1)
        logit = lin + pair
        p = 1.0 / (1.0 + np.exp(-logit))
        labels = (rng.random(batch) < p).astype(np.float32)
        yield idx.astype(np.int32), labels
