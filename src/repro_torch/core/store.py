"""Persistent RRR-set arena — the resident store behind `InfluenceEngine`
(``repro.core.store``: ``BitmapStore`` and its bookkeeping).

``BitmapStore`` is a single-device ``(capacity, n) uint8`` bitmap arena
with a power-of-two capacity grown by doubling, a fused per-vertex
``counter`` (paper C3), per-set ``sizes`` and ``live`` bits.  Where JAX
donated the arena to a ``dynamic_update_slice``, the port writes batches
in place into the preallocated tensor.

Each arena row is padded to ``padded_width(n)`` bytes (a multiple of 16,
pad bytes zero) so the selection and commit kernels read rows with
16-byte loads; ``R`` is the ``[:, :n]`` view, and snapshots carry plain
``(capacity, n)`` rows — the reference's format.

Padding rows (index >= ``count``) are all zero and masked by
``view().valid``; selection, ``hits`` and the counter are exact integer
sums, so results are seed for seed those of the JAX store.  The packed
and compressed stores live in `repro_torch.core.pack.stores`; every
single-device kind restores from every other's snapshot
(`store_from_state`).  Every store and factory runs on ``cuda`` unless
given ``device="cpu"`` (`repro_torch.device.resolve_device`).  Row
lifecycle (kill/replace/compact), pressure policies and the index and
sharded stores are not ported yet (ROADMAP A3, A6, A8).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import padded_width

MIN_CAPACITY = 16     # matches the reference's pad floor (1 << 4)


def next_pow2(x: int, floor: int = MIN_CAPACITY) -> int:
    """Smallest power of two >= max(x, floor)."""
    cap = max(int(floor), 1)
    while cap < x:
        cap <<= 1
    return cap


@dataclasses.dataclass(frozen=True)
class StoreView:
    """Read-only picture of an arena handed to a selection strategy:
    ``R (capacity, n) uint8`` (a row-padded view of the live arena) and
    the row mask ``valid = arange(capacity) < count & live``.  A view
    aliases the arena: read it before the store's next write."""
    representation: str
    R: torch.Tensor
    valid: torch.Tensor
    n: int
    count: int


def _coverage_stats(sizes, count: int, n: int) -> tuple[float, int]:
    """(avg fractional set coverage, max set size) from a sizes array —
    padding entries are zero, so sums/maxes ignore them."""
    sizes = sizes.cpu().numpy() if isinstance(sizes, torch.Tensor) else \
        np.asarray(sizes)
    avg_cov = float(sizes.sum()) / max(count, 1) / n
    return avg_cov, max(int(sizes.max()) if sizes.size else 1, 1)


def _bitmap_hits(R, valid, S):
    """Fraction of valid sets hit by each seed row; ``S (Q, L)``."""
    Q, L = S.shape
    memb = R.index_select(1, S.reshape(-1)).view(R.shape[0], Q, L) > 0
    hit = memb.any(dim=2) & valid[:, None]
    n_valid = valid.sum(dtype=torch.float32).clamp_min(1.0)
    return hit.sum(dim=0, dtype=torch.int32).to(torch.float32) / n_valid


class _ArenaBase:
    """Arena bookkeeping: pow2 capacity, doubling, fused counter, sizes
    and live bits (all rows live until the row lifecycle is ported)."""

    def __init__(self, n: int, *, capacity: int = MIN_CAPACITY,
                 device=None):
        self.n = int(n)
        self.device = resolve_device(device)
        self.capacity = next_pow2(capacity)
        self.count = 0
        self.dead = 0
        self.version = 0
        self.sizes = torch.zeros(self.capacity, dtype=torch.int32,
                                 device=self.device)
        self.counter = torch.zeros(self.n, dtype=torch.int32,
                                   device=self.device)
        self.live = torch.ones(self.capacity, dtype=torch.bool,
                               device=self.device)

    @property
    def live_count(self) -> int:
        return self.count - self.dead

    def _grow_rows(self, need: int):
        new_cap = next_pow2(need, self.capacity)
        if new_cap == self.capacity:
            return
        self._realloc(new_cap)
        sizes = torch.zeros(new_cap, dtype=torch.int32, device=self.device)
        sizes[:self.capacity] = self.sizes
        self.sizes = sizes
        self.live = torch.cat([self.live, torch.ones(
            new_cap - self.capacity, dtype=torch.bool, device=self.device)])
        self.capacity = new_cap

    def _finish_add(self, batch_sizes, counter):
        B = batch_sizes.shape[0]
        self.sizes[self.count:self.count + B] = batch_sizes
        self.counter += counter
        self._note_write(int(B))

    def _note_write(self, B: int):
        """Host-side bookkeeping after ``B`` rows landed in the arena."""
        self.count += int(B)
        self.version += 1
        if obs.enabled():
            obs.counter("store.rows_written").add(int(B))
            obs.gauge("store.occupancy").set(self.count / self.capacity)
            arena = self.capacity * self._row_bytes()
            obs.gauge("store.arena_bytes").set(arena)
            obs.gauge("store.bytes_per_device").set(arena)

    def _valid(self):
        iota = torch.arange(self.capacity, device=self.device)
        return (iota < self.count) & self.live

    @property
    def arena_bytes(self) -> int:
        """Device bytes the arena occupies, row padding included."""
        return self._arena.numel() * self._arena.element_size()

    def coverage_stats(self) -> tuple[float, int]:
        """(avg fractional set coverage, max set size) over live sets."""
        return _coverage_stats(self.sizes, self.live_count, self.n)

    def _base_state(self) -> dict:
        return {
            "n": np.int64(self.n),
            "count": np.int64(self.count),
            "sizes": self.sizes.cpu().numpy(),
            "counter": self.counter.cpu().numpy(),
            "live": self.live.cpu().numpy(),
        }

    def _restore_base(self, st) -> None:
        """Adopt copies of a snapshot's sizes, counter, count and live bits
        (absent in pre-streaming snapshots, where every filled row is
        live); the store updates them in place, never the caller's
        arrays."""
        self.sizes = torch.tensor(np.asarray(st["sizes"], np.int32),
                                  device=self.device)
        self.counter = torch.tensor(np.asarray(st["counter"], np.int32),
                                    device=self.device)
        self.count = int(st["count"])
        if "live" in st:
            live = np.asarray(st["live"]).astype(bool)
            self.live = torch.tensor(live, device=self.device)
            self.dead = int(self.count - live[:self.count].sum())


class BitmapStore(_ArenaBase):
    """Dense single-device bitmap arena: ``(capacity, n) uint8`` rows
    padded to a 16-byte stride, zero-padded rows."""

    representation = "bitmap"

    def __init__(self, n: int, *, capacity: int = MIN_CAPACITY,
                 device=None):
        super().__init__(n, capacity=capacity, device=device)
        self.row_stride = padded_width(self.n)
        self._arena = torch.zeros((self.capacity, self.row_stride),
                                  dtype=torch.uint8, device=self.device)

    @property
    def R(self) -> torch.Tensor:
        """The ``(capacity, n)`` view of the arena."""
        return self._arena[:, :self.n]

    def _realloc(self, new_cap: int):
        arena = torch.zeros((new_cap, self.row_stride), dtype=torch.uint8,
                            device=self.device)
        arena[:self.capacity] = self._arena
        self._arena = arena

    def _row_bytes(self) -> int:
        return self.n

    def add_batch(self, visited, counter=None) -> np.ndarray:
        """Append ``visited (B, n)`` 0/1 rows in place (the unfused write
        path); ``counter`` is the sampler's ``(n,) int32`` contribution,
        computed here when absent.  Returns the slots the rows landed in."""
        with obs.span("store.write", tier="store", kind="bitmap"):
            visited = visited.to(self.device, torch.uint8)
            B = int(visited.shape[0])
            self._grow_rows(self.count + B)
            if counter is None:
                counter = visited.sum(dim=0, dtype=torch.int32)
            slots = np.arange(self.count, self.count + B, dtype=np.int64)
            self.R[self.count:self.count + B] = visited
            self._finish_add(visited.sum(dim=1, dtype=torch.int32), counter)
        return slots

    def view(self) -> StoreView:
        return StoreView("bitmap", self.R, self._valid(), self.n, self.count)

    def hits(self, S) -> torch.Tensor:
        """Covered fraction per query: ``S (Q, L) int`` -> ``(Q,) f32``."""
        with obs.span("count", tier="store", kind="bitmap"):
            S = torch.as_tensor(np.asarray(S, np.int64), device=self.device)
            return _bitmap_hits(self.R, self._valid(), S)

    def state(self) -> dict:
        """Host snapshot tree: the ``(capacity, n)`` arena plus counters
        (kind tag ``"bitmap"``) — the reference's format."""
        st = self._base_state()
        st["kind"] = np.asarray("bitmap")
        st["R"] = self.R.cpu().numpy()
        return st

    @classmethod
    def from_state(cls, st, *, device=None) -> "BitmapStore":
        R = np.asarray(st["R"], np.uint8)
        store = cls(int(st["n"]), capacity=R.shape[0], device=device)
        if store.capacity != R.shape[0]:
            raise ValueError(f"snapshot arena has {R.shape[0]} rows, not a "
                             f"power of two >= {MIN_CAPACITY}")
        store.R.copy_(torch.from_numpy(np.require(R, None, ("C", "W"))))
        store._restore_base(st)
        return store

    @classmethod
    def from_rows(cls, rows, n: int, *, device=None) -> "BitmapStore":
        """A store holding exactly ``rows (count, n) uint8`` — the
        cross-representation restore path."""
        store = cls(int(n), capacity=max(int(rows.shape[0]), MIN_CAPACITY),
                    device=device)
        if rows.shape[0]:
            store.add_batch(torch.as_tensor(np.asarray(rows, np.uint8)))
        return store


_NOT_PORTED = {
    "indices": "the index-list store (ROADMAP A3)",
    "sharded": "the sharded store (ROADMAP A8)",
}
_KINDS = ("bitmap", "packed", "compressed")


def _store_class(kind: str):
    """The single-device store class of ``kind`` (``auto`` is bitmap)."""
    if kind in ("auto", "bitmap"):
        return BitmapStore
    if kind in ("packed", "compressed"):
        from repro_torch.core.pack.stores import (
            CompressedStore, PackedBitmapStore,
        )
        return PackedBitmapStore if kind == "packed" else CompressedStore
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"store {kind!r} is not ported yet: {_NOT_PORTED[kind]}")
    raise ValueError(f"unknown store kind {kind!r}; have "
                     f"{sorted(_KINDS + tuple(_NOT_PORTED))}")


def make_store(kind: str, n: int, *, device=None):
    """Store factory: ``"auto"``/``"bitmap"`` give a `BitmapStore`,
    ``"packed"`` a `PackedBitmapStore`, ``"compressed"`` a
    `CompressedStore`."""
    return _store_class(kind)(n, device=device)


def _live_rows_from_state(st) -> tuple[int, np.ndarray]:
    """Decode a bitmap, packed or compressed snapshot to its live bit
    rows: ``(n, (live rows, n) uint8)`` — the cross-representation
    interchange form that any store's ``from_rows`` re-encodes."""
    from repro_torch.core.pack.codec import token_decode_np, unpack_bits_np
    kind = str(np.asarray(st["kind"]))
    n, count = int(st["n"]), int(st["count"])
    R = np.asarray(st["R"])[:count]
    if kind == "packed":
        rows = unpack_bits_np(R, n)
    elif kind == "compressed":
        rows = token_decode_np(R, n)
    else:
        rows = np.asarray(R, np.uint8)
    if "live" in st:
        rows = rows[np.asarray(st["live"])[:count].astype(bool)]
    return n, rows


def store_from_state(st, *, device=None, kind: str = None):
    """Rebuild a store from a `state()` tree.  ``kind`` picks the target
    representation (None keeps the snapshot's own): the same kind
    restores the arena in place, another kind re-encodes the snapshot's
    live rows (`from_rows`), so bitmap, packed and compressed snapshots
    each restore into any of the three."""
    snap_kind = str(np.asarray(st["kind"]))
    target = snap_kind if kind is None else kind
    for k in (snap_kind, target):
        if k not in _KINDS:
            if k in _NOT_PORTED:
                raise NotImplementedError(
                    f"restoring a {snap_kind!r} snapshot as {target!r} "
                    f"needs {_NOT_PORTED[k]}")
            raise ValueError(f"unknown store kind {k!r}")
    cls = _store_class(target)
    if target == snap_kind:
        return cls.from_state(st, device=device)
    n, rows = _live_rows_from_state(st)
    return cls.from_rows(rows, n, device=device)
