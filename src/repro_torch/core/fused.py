"""Fused sample -> write -> count extender (``repro.core.fused``,
``_ArenaFused`` over a `BitmapStore` or a packed `CodecStore`).

One batch: the bound sampler produces the ``(B, n)`` visited rows, then
one ``arena_commit`` launch writes them into the arena's next ``B`` rows
in its at-rest form (bitmap bytes or LSB-first packed bytes), adds
their column sums into the fused counter and writes their row sums into
``sizes``: one pass over the batch.  The JAX chain returns
``stored`` for a separate donated ``_commit_write`` copy; here
``arena_commit`` writes the batch straight into ``R[count:count + B]``,
so that copy and its second pass over the batch are gone.  The PRNG
stream and every stored byte are those of the unfused path.

Token-compressed rows have no fused chain (the reference's
``_FUSED_KINDS``): `make_fused_extender` returns None and the engine
writes through ``store.add_batch`` with the same batch key.  The
extender also declines a batch that a `StorePressurePolicy` must make
room for: the store's ``add_batch`` alone enforces the policy (it may
compact, morph the codec down the ladder or evict), and the engine's
unfused path takes the batch with the same key.
"""
from __future__ import annotations

from repro_torch import obs
from repro_torch.kernels import ops as kops

# the at-rest forms arena_commit covers
_FUSED_KINDS = kops.COMMIT_KINDS


def make_fused_extender(store, sample, cfg, *, sampler_name: str):
    """The fused extender for ``(store, bound sampler)``, or None when the
    store's at-rest form has no fused chain."""
    if store.representation in _FUSED_KINDS:
        return _ArenaFused(store, sample, int(cfg.batch),
                           sampler_name=sampler_name)
    return None


class _ArenaFused:
    """Fused extender over a single-device bitmap or packed arena."""

    def __init__(self, store, sample, batch: int, *, sampler_name: str):
        self.store = store
        self._sample = sample
        self.batch = batch
        self.sampler_name = sampler_name

    def extend_once(self, key) -> bool:
        """Sample and commit one batch; False (nothing sampled) when the
        arena's form has no fused chain or the batch would cross the
        policy's row cap."""
        s, B = self.store, self.batch
        kind = s.representation
        cap = s.row_cap
        if kind not in _FUSED_KINDS or (cap is not None
                                        and s.count + B > cap):
            return False
        s._grow_rows(s.count + B)
        with obs.span("sample", tier="engine", sampler=self.sampler_name,
                      fused=True):
            visited, _, _ = self._sample(key)
        with obs.span("store.write", tier="store", kind=kind, fused=True):
            lo, hi = s.count, s.count + B
            s._commit(visited, s.R[lo:hi], s.sizes[lo:hi])
        s._note_write(B)
        return True
