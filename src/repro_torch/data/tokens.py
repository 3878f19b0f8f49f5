"""Deterministic synthetic token pipeline, shard-aware and seeded
(``repro.data.tokens``; numpy, the reference's draws bit for bit).

Zipf-distributed token streams with local bigram structure, so that a
~100M LM shows a falling loss curve.  Every batch is a pure function of
(seed, step, shard): a restart needs no loader state in its checkpoint,
and each data shard draws its own stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    batch: int              # per-host batch
    seq_len: int
    seed: int = 0
    shard: int = 0
    num_shards: int = 1
    zipf_a: float = 1.2

    def batch_at(self, step: int):
        """-> (tokens (batch, seq_len) int32, labels (batch, seq_len) int32).

        Labels are next-token targets (tokens shifted left; final label is
        masked with -1).
        """
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard)
        b, s, v = self.batch, self.seq_len, self.vocab
        # Zipf base stream + deterministic bigram structure: with p=0.5 the
        # next token is f(prev) (a fixed random permutation), giving the LM
        # something learnable.
        base = rng.zipf(self.zipf_a, size=(b, s)).astype(np.int64)
        base = np.minimum(base, v - 1)
        perm_rng = np.random.default_rng(self.seed)  # shared across steps
        perm = perm_rng.permutation(v)
        copy_mask = rng.random((b, s)) < 0.5
        toks = base.copy()
        for i in range(1, s):
            follow = perm[toks[:, i - 1]]
            toks[:, i] = np.where(copy_mask[:, i], follow, base[:, i])
        labels = np.concatenate(
            [toks[:, 1:], np.full((b, 1), -1, np.int64)], axis=1)
        return toks.astype(np.int32), labels.astype(np.int32)


def synthetic_token_batches(vocab: int, batch: int, seq_len: int, steps: int,
                            *, seed: int = 0, shard: int = 0,
                            num_shards: int = 1):
    pipe = TokenPipeline(vocab=vocab, batch=batch, seq_len=seq_len, seed=seed,
                         shard=shard, num_shards=num_shards)
    for step in range(steps):
        yield pipe.batch_at(step)
