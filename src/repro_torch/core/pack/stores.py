"""Single-device encoded RRR arenas (``repro.core.pack.stores``):
`PackedBitmapStore` and `CompressedStore`, one arena class (`CodecStore`)
parameterized by the at-rest codec.

Rows arrive as ``(B, n) uint8`` bitmaps and are encoded on write; every
read (counting, ``hits``, selection) decodes on the fly, so the logical
``(theta, n)`` arena never rests in memory.  The engine's fused chain
writes a packed batch with one ``arena_commit(kind="packed")`` launch
(`repro_torch.core.fused`); `add_batch` encodes in PyTorch — the only
write path of the compressed store, which has no fused chain, as in the
reference.

The packed arena's rows are padded to a 16-byte stride (pad bytes zero)
so the kernels read them with 16-byte loads; ``R`` is the
``(capacity, ceil(n/8))`` view and snapshots carry plain
``(capacity, codec.width)`` rows, the reference's format.  A compressed
store widens ``s_pad`` by powers of two when a batch needs more tokens
(`_widen_tokens`), holding the old and the new arena for a moment.

``index_view`` decodes the arena a block of rows at a time into C4 index
lists (`repro_torch.core.adaptive.bitmap_to_indices`), cached until the
arena next changes.  The pressure ladder that morphs a codec in place
(``_compress_step``) is not ported yet (ROADMAP A6).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.pack.codec import (
    MIN_TOKEN_PAD, TokenCodec, codec_for, tokens_needed,
)
from repro_torch.core.store import (
    MIN_CAPACITY, StoreView, _ArenaBase, _cached_index_view, next_pow2,
)
from repro_torch.kernels.ops import padded_width


class CodecStore(_ArenaBase):
    """Single-device encoded arena: ``(capacity, codec.width)`` of
    ``codec.dtype``.  Use the `PackedBitmapStore` / `CompressedStore`
    subclasses to pick the codec."""

    _initial_kind = "packed"

    def __init__(self, n: int, *, capacity: int = MIN_CAPACITY,
                 device=None, s_pad: int = MIN_TOKEN_PAD):
        super().__init__(n, capacity=capacity, device=device)
        self.codec = codec_for(self._initial_kind, self.n,
                               s_pad=next_pow2(s_pad, MIN_TOKEN_PAD))
        self._arena = self._new_arena(self.capacity)

    @property
    def representation(self) -> str:
        return self.codec.kind

    @property
    def row_stride(self) -> int:
        """Elements per arena row: the codec width padded to 16 bytes."""
        item = torch.empty((), dtype=self.codec.dtype).element_size()
        return padded_width(self.codec.width * item) // item

    @property
    def R(self) -> torch.Tensor:
        """The ``(capacity, codec.width)`` view of the arena."""
        return self._arena[:, :self.codec.width]

    def _new_arena(self, capacity: int) -> torch.Tensor:
        return torch.full((capacity, self.row_stride), self.codec.fill,
                          dtype=self.codec.dtype, device=self.device)

    # ------------------------------------------------- arena base hooks ----

    def _realloc(self, new_cap: int):
        arena = self._new_arena(new_cap)
        arena[:self.capacity] = self._arena
        self._arena = arena

    def _row_bytes(self) -> int:
        # at-rest bytes per row: what the obs byte gauges report
        return self.codec.width * self._arena.element_size()

    def _widen_tokens(self, s_need: int):
        new_s = next_pow2(s_need, self.codec.s_pad)
        if new_s == self.codec.s_pad:
            return
        old = self.R
        self.codec = TokenCodec(self.n, new_s)
        self._arena = self._new_arena(self.capacity)
        self._arena[:, :old.shape[1]] = old
        self.version += 1

    def _compress_step(self) -> bool:
        raise NotImplementedError(
            "codec morphs under a pressure policy are not ported yet "
            "(ROADMAP A6)")

    def index_view(self, l_pad: int) -> StoreView:
        """The decoded arena as C4 index lists ``(capacity, l_pad)
        int32``, cached until the arena next changes."""
        return _cached_index_view(
            self, l_pad, lambda lo, hi: self.codec.decode(self.R[lo:hi]))

    # -------------------------------------------------------- RRR store ----

    def add_batch(self, visited, counter=None) -> np.ndarray:
        """Encode and append ``visited (B, n)`` 0/1 rows; ``counter`` is
        the sampler's ``(n,) int32`` contribution, computed here when
        absent.  Returns the slots the rows landed in."""
        with obs.span("store.write", tier="store", kind=self.codec.kind):
            visited = visited.to(self.device, torch.uint8)
            B = int(visited.shape[0])
            batch_sizes = visited.sum(dim=1, dtype=torch.int32)
            if isinstance(self.codec, TokenCodec):
                self._widen_tokens(int(tokens_needed(visited).max()))
            self._grow_rows(self.count + B)
            if counter is None:
                counter = visited.sum(dim=0, dtype=torch.int32)
            slots = np.arange(self.count, self.count + B, dtype=np.int64)
            self.R[self.count:self.count + B] = self.codec.encode(visited)
            self._finish_add(batch_sizes, counter)
        return slots

    def view(self) -> StoreView:
        return StoreView(self.representation, self.R, self._valid(),
                         self.n, self.count)

    def hits(self, S) -> torch.Tensor:
        """Covered fraction per query: ``S (Q, L) int`` -> ``(Q,) f32``,
        one query's ``decode_cols`` membership at a time."""
        with obs.span("count", tier="store", kind=self.codec.kind):
            S = torch.as_tensor(np.asarray(S, np.int64), device=self.device)
            valid = self._valid()
            R = self.R
            hit = torch.stack([
                (self.codec.decode_cols(R, s).any(dim=-1) & valid).sum(
                    dtype=torch.int32) for s in S])
            n_valid = valid.sum(dtype=torch.float32).clamp_min(1.0)
            return hit.to(torch.float32) / n_valid

    def state(self) -> dict:
        """Host snapshot: the *encoded* ``(capacity, codec.width)`` arena
        plus counters; the kind tag is the codec kind."""
        st = self._base_state()
        st["kind"] = np.asarray(self.codec.kind)
        st["R"] = self.R.cpu().numpy()
        return st

    @classmethod
    def from_state(cls, st, *, device=None) -> "CodecStore":
        kind = str(np.asarray(st["kind"]))
        if kind != cls._initial_kind:
            raise ValueError(f"a {kind!r} snapshot does not restore into "
                             f"{cls.__name__}; use store_from_state")
        R = np.asarray(st["R"])
        store = cls(int(st["n"]), capacity=R.shape[0], device=device,
                    s_pad=R.shape[1])
        if store.capacity != R.shape[0]:
            raise ValueError(f"snapshot arena has {R.shape[0]} rows, not a "
                             f"power of two >= {MIN_CAPACITY}")
        if store.codec.width != R.shape[1]:
            if kind != "compressed":
                raise ValueError(f"{kind} snapshot rows are {R.shape[1]} "
                                 f"wide, the codec's {store.codec.width}")
            # a token width that is not a power of two >= MIN_TOKEN_PAD
            store.codec = TokenCodec(store.n, R.shape[1])
            store._arena = store._new_arena(store.capacity)
        store.R.copy_(torch.from_numpy(np.require(R, None, ("C", "W"))))
        store._restore_base(st)
        return store

    @classmethod
    def from_rows(cls, rows, n: int, *, device=None) -> "CodecStore":
        """A store holding exactly ``rows (count, n) uint8`` bit rows —
        the cross-representation restore path."""
        store = cls(int(n), capacity=max(int(rows.shape[0]), MIN_CAPACITY),
                    device=device)
        if rows.shape[0]:
            store.add_batch(torch.as_tensor(np.asarray(rows, np.uint8)))
        return store


class PackedBitmapStore(CodecStore):
    """Bit-packed arena: ``(capacity, ceil(n/8)) uint8`` — 8x smaller at
    rest than `BitmapStore`, bitwise-identical in every answer."""
    _initial_kind = "packed"


class CompressedStore(CodecStore):
    """Compressed-at-rest arena: per-row literal/run token lists
    (``(capacity, s_pad) int32``), decode-and-count on every read."""
    _initial_kind = "compressed"
