"""Fused sample -> write -> count extender (``repro.core.fused``,
``_ArenaFused`` over a `BitmapStore`).

One batch: the bound sampler produces the ``(B, n)`` visited rows, then
one ``arena_commit`` launch writes them into the arena's next ``B`` rows
and adds their column sums into the fused counter.  The JAX chain returns
``stored`` for a separate donated ``_commit_write`` copy; here
``arena_commit`` writes the batch straight into ``R[count:count + B]``,
so that copy and its second pass over the batch are gone.  The PRNG
stream and every stored byte are those of the unfused path.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.store import BitmapStore
from repro_torch.kernels import ops as kops


def make_fused_extender(store, sample, cfg, *, sampler_name: str):
    """The fused extender for ``(store, bound sampler)``, or None when the
    store has no fused chain."""
    if isinstance(store, BitmapStore):
        return _ArenaFused(store, sample, int(cfg.batch),
                           sampler_name=sampler_name)
    return None


class _ArenaFused:
    """Fused extender over a `BitmapStore`."""

    def __init__(self, store, sample, batch: int, *, sampler_name: str):
        self.store = store
        self._sample = sample
        self.batch = batch
        self.sampler_name = sampler_name

    def extend_once(self, key) -> bool:
        s, B = self.store, self.batch
        s._grow_rows(s.count + B)
        with obs.span("sample", tier="engine", sampler=self.sampler_name,
                      fused=True):
            visited, _, _ = self._sample(key)
        with obs.span("store.write", tier="store", kind="bitmap",
                      fused=True):
            lo, hi = s.count, s.count + B
            kops.arena_commit(visited, s.R[lo:hi], s.counter)
            s.sizes[lo:hi] = visited.sum(dim=1, dtype=torch.int32)
        s._note_write(B)
        return True
