"""Single-device encoded RRR arenas (``repro.core.pack.stores``):
`PackedBitmapStore` and `CompressedStore`, one arena class (`CodecStore`)
parameterized by the at-rest codec.

Rows arrive as ``(B, n) uint8`` bitmaps and are encoded on write; every
read (counting, ``hits``, selection) decodes on the fly, so the logical
``(theta, n)`` arena never rests in memory.  The engine's fused chain
writes a packed batch with one ``arena_commit(kind="packed")`` launch
(`repro_torch.core.fused`), and so do a packed store's `add_batch` and
``replace_rows`` (the streaming writes).  Token rows are encoded in
PyTorch: the compressed store has no fused chain, as in the
reference.

The packed arena's rows are padded to a 16-byte stride (pad bytes zero)
so the kernels read them with 16-byte loads; ``R`` is the
``(capacity, ceil(n/8))`` view and snapshots carry plain
``(capacity, codec.width)`` rows, the reference's format.  A compressed
store widens ``s_pad`` by powers of two when a batch needs more tokens
(`_widen_tokens`), holding the old and the new arena for a moment.

``index_view`` decodes the arena a block of rows at a time into C4 index
lists (`repro_torch.core.adaptive.bitmap_to_indices`), cached until the
arena next changes.

Under a `StorePressurePolicy` with a ``ladder``, an arena over its cap
first morphs its codec down the ladder (packed -> compressed) before any
live row is evicted: `_compress_step` re-encodes the arena a block of
rows at a time (`_recode`; neither the decoded bits nor the token
count's input ever exist for the whole arena) and the store keeps its
class, so ``representation`` follows ``codec.kind``.  The row
lifecycle's counter contribution (`_row_contrib`) is the
``packed_count`` or ``token_count`` kernel over a mask of the rows.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import store as _store_mod
from repro_torch.core.pack.codec import (
    MIN_TOKEN_PAD, TokenCodec, codec_for, tokens_needed,
)
from repro_torch.core.store import (
    MIN_CAPACITY, StoreView, _ArenaBase, _cached_index_view, _ladder_next,
    next_pow2,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ops import padded_width

#: rows per block of the codec morph (bounds its decoded temporaries)
RECODE_ROWS = 1024


def _recode(src, dst, codec_from, codec_to):
    """Re-encode arena rows ``src`` (under ``codec_from``) into ``dst``
    (under ``codec_to``) a block of rows at a time."""
    for lo in range(0, src.shape[0], RECODE_ROWS):
        hi = lo + RECODE_ROWS
        dst[lo:hi] = codec_to.encode(codec_from.decode(src[lo:hi]))


def _max_tokens(R, codec) -> int:
    """The most tokens any row of ``R`` (under ``codec``) needs, a block
    of rows at a time."""
    need = 0
    for lo in range(0, R.shape[0], RECODE_ROWS):
        need = max(need, int(tokens_needed(codec.decode(
            R[lo:lo + RECODE_ROWS])).max()))
    return need


class CodecStore(_ArenaBase):
    """Single-device encoded arena: ``(capacity, codec.width)`` of
    ``codec.dtype``.  Use the `PackedBitmapStore` / `CompressedStore`
    subclasses to pick the codec."""

    _initial_kind = "packed"

    def __init__(self, n: int, *, capacity: int = MIN_CAPACITY,
                 policy=None, device=None, s_pad: int = MIN_TOKEN_PAD):
        super().__init__(n, capacity=capacity, policy=policy, device=device)
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

    def _fill_value(self) -> int:
        return self.codec.fill

    def _rows_for_storage(self, rows):
        if isinstance(self.codec, TokenCodec):
            self._widen_tokens(int(tokens_needed(rows).max()))
        return self.codec.encode(rows)

    def _row_contrib(self, mask) -> torch.Tensor:
        """The counter contribution of the masked rows, decoded and
        counted in the ``packed_count`` or ``token_count`` kernel."""
        if self.codec.kind == "packed":
            return kops.packed_count(self.R, mask, n=self.n)
        return kops.token_count(self.R, mask, n=self.n)

    def _compress_step(self) -> bool:
        """Morph the arena one step down the policy's ladder (packed ->
        compressed: the token width covers every resident row; unfilled
        rows decode to no bits and re-encode as fill).  True when a step
        was taken."""
        ladder = self.policy.ladder if self.policy is not None else ()
        nxt = _ladder_next(self.codec.kind, ladder)
        if nxt is None:
            return False
        if nxt == "compressed":
            need = _max_tokens(self.R, self.codec)
            new_codec = codec_for(nxt, self.n, s_pad=next_pow2(
                max(need, 1), MIN_TOKEN_PAD))
        else:
            new_codec = codec_for(nxt, self.n)
        old_R, old_codec = self.R, self.codec
        self.codec = new_codec
        self._arena = self._new_arena(self.capacity)
        _recode(old_R, self.R, old_codec, new_codec)
        self.version += 1
        obs.counter("store.compress_steps").add(1)
        return True

    def index_view(self, l_pad: int) -> StoreView:
        """The decoded arena as C4 index lists ``(capacity, l_pad)
        int32``, cached until the arena next changes."""
        return _cached_index_view(
            self, l_pad, lambda lo, hi: self.codec.decode(self.R[lo:hi]))

    # -------------------------------------------------------- RRR store ----

    def add_batch(self, visited, counter=None) -> np.ndarray:
        """Encode and append ``visited (B, n)`` 0/1 rows.  Packed rows go
        through one ``arena_commit`` launch, which counts the batch's
        columns itself; token rows are encoded here and add ``counter``,
        the sampler's ``(n,) int32`` contribution (computed here when
        absent).  Returns the slots the rows landed in."""
        with obs.span("store.write", tier="store", kind=self.codec.kind):
            visited = visited.to(self.device)
            B = int(visited.shape[0])
            kind = self.codec.kind
            if isinstance(self.codec, TokenCodec):
                self._widen_tokens(int(tokens_needed(visited).max()))
            self._ensure_room(B)
            if self.codec.kind != kind and isinstance(self.codec, TokenCodec):
                # the ladder just sized its tokens for the resident rows:
                # size them for this batch too, and fit the cap again (the
                # reference writes the batch at the resident width and
                # cuts rows that need more tokens)
                self._widen_tokens(int(tokens_needed(visited).max()))
                self._ensure_room(B)
            self._grow_rows(self.count + B)
            lo, hi = self.count, self.count + B
            if self.codec.kind in kops.COMMIT_KINDS:
                self._commit(visited, self.R[lo:hi], self.sizes[lo:hi])
                self._note_write(B)
            else:
                if counter is None:
                    counter = visited.sum(dim=0, dtype=torch.int32)
                self.R[lo:hi] = self.codec.encode(visited)
                self._finish_add(visited.sum(dim=1, dtype=torch.int32),
                                 counter)
        return np.arange(lo, hi, dtype=np.int64)

    def view(self) -> StoreView:
        return StoreView(self.representation, self.R, self._valid(),
                         self.n, self.count)

    def rows_touching(self, verts) -> torch.Tensor:
        """Rows whose traversal touched any of ``verts``: ``decode_cols``
        of the touched columns (the arena never expands)."""
        v = torch.as_tensor(np.asarray(verts, np.int64), device=self.device)
        return self.codec.decode_cols(self.R, v).any(dim=1)

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
    def from_rows(cls, rows, n: int, *, policy=None,
                  device=None) -> "CodecStore":
        """A store holding exactly ``rows (count, n) uint8`` bit rows —
        the cross-representation restore path; ``_restore_slots``
        records the slot each row landed in."""
        store = cls(int(n), capacity=max(int(rows.shape[0]), MIN_CAPACITY),
                    policy=policy, device=device)
        store._restore_slots = (
            store.add_batch(torch.as_tensor(np.asarray(rows, np.uint8)))
            if rows.shape[0] else np.zeros((0,), np.int64))
        return store


class PackedBitmapStore(CodecStore):
    """Bit-packed arena: ``(capacity, ceil(n/8)) uint8`` — 8x smaller at
    rest than `BitmapStore`, bitwise-identical in every answer."""
    _initial_kind = "packed"


class CompressedStore(CodecStore):
    """Compressed-at-rest arena: per-row literal/run token lists
    (``(capacity, s_pad) int32``), decode-and-count on every read."""
    _initial_kind = "compressed"


_store_mod.STORE_KINDS["packed"] = PackedBitmapStore
_store_mod.STORE_KINDS["compressed"] = CompressedStore
