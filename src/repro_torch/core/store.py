"""Persistent RRR-set arenas — the resident store behind `InfluenceEngine`
(``repro.core.store``: ``BitmapStore``, ``IndexStore`` and their
bookkeeping).

``BitmapStore`` is a single-device ``(capacity, n) uint8`` bitmap arena
with a power-of-two capacity grown by doubling, a fused per-vertex
``counter`` (paper C3), per-set ``sizes`` and ``live`` bits.  Where JAX
donated the arena to a ``dynamic_update_slice``, the port writes batches
in place into the preallocated tensor.

Each arena row is padded to ``padded_width(n)`` bytes (a multiple of 16,
pad bytes zero) so the selection and commit kernels read rows with
16-byte loads; ``R`` is the ``[:, :n]`` view, and snapshots carry plain
``(capacity, n)`` rows — the reference's format.

``IndexStore`` keeps the paper's C4 index lists: ``(capacity, l_pad)
int32`` rows of ascending member ids padded with the sentinel ``n``;
``l_pad`` widens by powers of two when a longer set arrives.  Batches
come as bitmaps (converted on write) or, from the sparse sampler, as
index rows already (`add_index_batch`).  A bitmap or encoded store
derives the same lists lazily for index-list selection
(``index_view``, cached until the arena changes).

Padding rows (index >= ``count``) are all zero (all sentinel) and masked
by ``view().valid``; selection, ``hits`` and the counter are exact
integer sums, so results are seed for seed those of the JAX store.  The
packed and compressed stores live in `repro_torch.core.pack.stores`;
the bitmap, packed and compressed kinds restore from each other's
snapshots, an index store from an index snapshot only
(`store_from_state`).  Every store and factory runs on ``cuda`` unless
given ``device="cpu"`` (`repro_torch.device.resolve_device`).

Streaming (`repro_torch.stream`) drives a **row lifecycle** on every
store, in place: ``kill_rows(mask)`` marks rows dead and subtracts their
counter contribution (`_row_contrib`: the ``coverage_matvec`` kernel
over a bitmap arena, ``packed_count``/``token_count`` over an encoded
one, so no float copy of the arena is made), ``replace_rows(idx, rows)``
writes fresh rows into dead slots and revives them (bitmap and packed
rows, like every bitmap or packed ``add_batch``, through one
``arena_commit`` launch), and ``compact()``
moves the live rows to the arena head a block of rows at a time and
returns the old -> new slot remap.  A `StorePressurePolicy` caps the
arena's rows or bytes: a write over the cap first compacts
(staleness-first), then walks the policy's codec ladder
(compress-before-evict, `_compress_step`), then evicts the oldest live
rows.  The policy is enforced by the store's write entry points
(``add_batch``, ``replace_rows``) alone.

``ShardedStore`` is the arena on a `repro_torch.mesh.Mesh` (paper C1):
one tile per (theta shard, vertex shard), each its own tensor on its own
device in the reference's layout, written by ``arena_commit`` a tile at
a time and read in place by the sharded selections; its snapshots
restore onto any layout and into any single-device store.  Its row
lifecycle and pressure policy wait for ROADMAP A8b.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import mesh as mesh_ops
from repro_torch import obs
from repro_torch.core.adaptive import CONVERT_BLOCK_ELEMS, bitmap_to_indices
from repro_torch.device import resolve_device
from repro_torch.graphs.partition import vertex_partition
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ops import padded_width
from repro_torch.sparse.scatter import bincount_weighted

MIN_CAPACITY = 16     # matches the reference's pad floor (1 << 4)
MIN_INDEX_PAD = 4     # matches the reference's l_pad floor (1 << 2)


def next_pow2(x: int, floor: int = MIN_CAPACITY) -> int:
    """Smallest power of two >= max(x, floor)."""
    cap = max(int(floor), 1)
    while cap < x:
        cap <<= 1
    return cap


@dataclasses.dataclass(frozen=True)
class StorePressurePolicy:
    """Bounded-memory contract for an indefinite stream of batches.

    ``max_rows`` caps the arena's row capacity directly; ``max_bytes``
    caps it through the store's at-rest bytes per row (``n`` for
    bitmaps, ``4 * l_pad`` for index lists, ``ceil(n/8)`` packed,
    ``4 * s_pad`` compressed); when both are set the tighter one wins.
    Victims under pressure: dead rows first (compaction), then the
    oldest live rows, FIFO.  ``ladder`` is an ordered tuple of codec
    kinds (of ``("packed", "compressed")``) the arena may morph *down*
    through before it evicts a live row (compress-before-evict); stores
    with a fixed layout ignore it.
    """
    max_rows: int | None = None
    max_bytes: int | None = None
    ladder: tuple = ()

    def row_cap(self, row_bytes: int) -> int | None:
        """Row capacity for a store of ``row_bytes`` a row, or None when
        the policy is unbounded."""
        caps = []
        if self.max_rows is not None:
            caps.append(int(self.max_rows))
        if self.max_bytes is not None:
            caps.append(int(self.max_bytes) // max(int(row_bytes), 1))
        if not caps:
            return None
        cap = min(caps)
        if cap < 1:
            raise ValueError(
                f"StorePressurePolicy resolves to a row cap of {cap} "
                f"(row_bytes={row_bytes}); the cap must hold >= 1 row")
        return cap


_LADDER_RANK = {"bitmap": 0, "packed": 1, "compressed": 2}


def _ladder_next(current_kind: str, ladder) -> str | None:
    """The next codec kind a pressure ladder may morph ``current_kind``
    down to, or None when the ladder is exhausted; only strictly denser
    kinds qualify, so a ladder never decompresses an arena."""
    rank = _LADDER_RANK.get(current_kind, 0)
    for kind in ladder:
        if _LADDER_RANK.get(kind, -1) > rank:
            return kind
    return None


@dataclasses.dataclass(frozen=True)
class StoreView:
    """Read-only picture of an arena handed to a selection strategy:
    ``R (capacity, n) uint8`` (a row-padded view of the live arena) and
    the row mask ``valid = arange(capacity) < count & live``; a
    `ShardedStore`'s ``R`` is its ``[Dt][Dv]`` grid of tiles and its
    ``valid`` one mask per theta shard.  A view aliases the arena: read
    it before the store's next write."""
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


def _index_hits(R_idx, valid, S, n: int):
    """`_bitmap_hits` over index lists ``R_idx (capacity, L)`` (sentinel
    ``n``): one query at a time, its members marked in an ``(n + 2,)``
    mask that is gathered at every list entry, so the ``(capacity, L,
    Lq)`` compare is never built.  A query id of ``n`` matches the
    sentinel padding, as the reference's compare does; ids outside
    ``[0, n]`` match nothing (they mark the spare slot ``n + 1``)."""
    flat = R_idx.reshape(-1)
    n_valid = valid.sum(dtype=torch.float32).clamp_min(1.0)
    hits = torch.empty(S.shape[0], dtype=torch.int32, device=R_idx.device)
    for q in range(S.shape[0]):
        s = S[q]
        s = torch.where((s >= 0) & (s <= n), s, n + 1)
        mask = torch.zeros(n + 2, dtype=torch.bool, device=R_idx.device)
        mask[s] = True
        memb = mask.index_select(0, flat).view(R_idx.shape).any(dim=1)
        hits[q] = (memb & valid).sum(dtype=torch.int32)
    return hits.to(torch.float32) / n_valid


def _cached_index_view(store, l_pad: int, rows) -> StoreView:
    """A dense store's index view: ``rows(lo, hi)`` gives its bit rows
    ``[lo, hi)`` as ``(hi - lo, n) uint8``, converted a block at a time
    into one ``(capacity, l_pad)`` list arena, kept while
    ``(version, l_pad)`` holds."""
    key = (store.version, int(l_pad))
    if store._idx_cache is None or store._idx_cache[0] != key:
        store._idx_cache = None     # drop the old lists before building
        out = torch.empty((store.capacity, int(l_pad)), dtype=torch.int32,
                          device=store.device)
        step = max(1, CONVERT_BLOCK_ELEMS // max(store.n, 1))
        for lo in range(0, store.capacity, step):
            hi = min(lo + step, store.capacity)
            bitmap_to_indices(rows(lo, hi), int(l_pad), out=out[lo:hi])
        store._idx_cache = (key, out)
    return StoreView("indices", store._idx_cache[1], store._valid(),
                     store.n, store.count)


@runtime_checkable
class RRRStore(Protocol):
    """What `InfluenceEngine` and `repro_torch.stream` ask of a store:
    ``add_batch(visited, counter=None)`` appends ``(B, n)`` 0/1 rows in
    place and returns the slots they landed in; ``view()`` is a
    `StoreView` aliasing the arena; ``hits(S)`` answers ``(Q, L)``
    seed-set queries as covered fractions; ``state()`` is a host tree
    for `repro_torch.checkpoint`.  Streaming adds the row lifecycle
    (``kill_rows``, ``replace_rows``, ``compact``, ``live_count``,
    ``row_cap``)."""
    representation: str
    n: int
    count: int
    capacity: int
    version: int
    counter: torch.Tensor
    sizes: torch.Tensor

    def add_batch(self, visited, counter=None) -> np.ndarray: ...
    def view(self) -> StoreView: ...
    def hits(self, S) -> torch.Tensor: ...
    def coverage_stats(self) -> tuple[float, int]: ...
    def state(self) -> dict: ...


class _ArenaBase:
    """Arena bookkeeping: pow2 capacity, doubling, fused counter, sizes,
    live bits and the row lifecycle (kill, replace, compact, pressure
    policy).  A store class supplies ``_arena`` (the padded buffer),
    ``R``, ``_realloc``, ``_row_bytes``, ``_fill_value``,
    ``_row_contrib`` and, for an at-rest form that ``arena_commit`` does
    not write, ``_rows_for_storage``."""

    def __init__(self, n: int, *, capacity: int = MIN_CAPACITY,
                 policy: StorePressurePolicy | None = None, device=None):
        self.n = int(n)
        self.device = resolve_device(device)
        self.capacity = next_pow2(capacity)
        self.count = 0
        self.dead = 0           # filled rows whose live bit is cleared
        self.version = 0
        self.policy = policy
        self.track_remaps = False   # StreamEngine logs compaction remaps
        self._remaps: list[np.ndarray] = []
        self.sizes = torch.zeros(self.capacity, dtype=torch.int32,
                                 device=self.device)
        self.counter = torch.zeros(self.n, dtype=torch.int32,
                                   device=self.device)
        self.live = torch.ones(self.capacity, dtype=torch.bool,
                               device=self.device)
        self._idx_cache = None      # ((version, l_pad), index lists)

    @property
    def live_count(self) -> int:
        return self.count - self.dead

    def _grow_rows(self, need: int):
        new_cap = next_pow2(need, self.capacity)
        cap = self.row_cap
        if cap is not None:
            # clamped to the policy cap (possibly not a power of two);
            # _ensure_room already made need <= cap
            new_cap = min(new_cap, max(cap, self.capacity))
        if new_cap == self.capacity:
            return
        self._realloc(new_cap)
        sizes = torch.zeros(new_cap, dtype=torch.int32, device=self.device)
        sizes[:self.capacity] = self.sizes
        self.sizes = sizes
        self.live = torch.cat([self.live, torch.ones(
            new_cap - self.capacity, dtype=torch.bool, device=self.device)])
        self.capacity = new_cap

    def _commit(self, rows, out, sizes) -> None:
        """Write ``rows (B, n)`` 0/1 into ``out`` (``B`` rows of the
        arena's at-rest form, bitmap or packed, over a padded stride)
        with one ``arena_commit`` launch, which adds their column sums
        into the counter and writes their row sums into ``sizes``."""
        kops.arena_commit(kops.commit_rows(rows), out, self.counter,
                          kind=self.representation, sizes=sizes)

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
            obs.gauge("store.compress_ratio").set(
                self.capacity * self.n / max(arena, 1))

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

    # ---------------------------------------------------- row lifecycle ----

    @property
    def row_cap(self) -> int | None:
        """The policy's row capacity for this store, or None."""
        if self.policy is None:
            return None
        return self.policy.row_cap(self._row_bytes())

    def live_mask(self) -> torch.Tensor:
        """``(capacity,) bool`` live bits (True for unfilled slots too:
        mask by the fill prefix, as ``view().valid`` does)."""
        return self.live

    def drain_remaps(self) -> list[np.ndarray]:
        """Pop the slot remaps recorded since the last drain (recorded
        only while ``track_remaps`` is set): old slot -> new slot, -1 for
        a reclaimed slot, to apply in order."""
        out, self._remaps = self._remaps, []
        return out

    def kill_rows(self, dead) -> int:
        """Mark rows dead (stale or evicted): they leave ``view().valid``,
        ``hits`` and the fused counter at once, and the next `compact`
        reclaims their slots.  ``dead`` is a ``(capacity,)`` bool mask
        (host or device); bits outside the filled, live rows are
        ignored.  Returns the number of newly dead rows."""
        dead = torch.as_tensor(dead, device=self.device).to(torch.bool) \
            & self._valid()
        k = int(dead.sum())
        if k == 0:
            return 0
        self.counter -= self._row_contrib(dead)
        self.sizes.masked_fill_(dead, 0)
        self.live &= ~dead
        self.dead += k
        self.version += 1
        obs.counter("store.rows_killed").add(k)
        return k

    def replace_rows(self, idx, rows) -> None:
        """Write fresh ``rows (K, n)`` 0/1 into the dead slots ``idx (K,)``
        and revive them (the streaming refresh write).  Targets must be
        filled, dead slots; entries of -1 are padding: their rows are
        neither stored nor counted.  Bitmap and packed rows go through
        one ``arena_commit`` launch into a block, then into their slots.
        Under a policy the store then fits its cap again (a token
        widening lowers the row cap), which may compact and evict."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        real = idx >= 0
        k = int(real.sum())
        if k == 0:
            return
        tgt = idx[real]
        if (tgt >= self.count).any() or self.live.cpu().numpy()[tgt].any():
            raise ValueError("replace_rows targets must be filled, dead "
                             "slots (kill_rows them first)")
        with obs.span("store.write", tier="store", kind="replace"):
            rows = torch.as_tensor(rows).to(self.device)
            if k != rows.shape[0]:
                rows = rows.index_select(0, torch.as_tensor(
                    np.flatnonzero(real), device=self.device))
            if self.representation in kops.COMMIT_KINDS:
                stored = torch.empty(
                    (k, self._arena.shape[1]), dtype=self._arena.dtype,
                    device=self.device)[:, :self.R.shape[1]]
                row_sizes = torch.empty(k, dtype=torch.int32,
                                        device=self.device)
                self._commit(rows, stored, row_sizes)
            else:
                rows = rows.to(torch.uint8)
                row_sizes = rows.sum(dim=1, dtype=torch.int32)
                self.counter += rows.sum(dim=0, dtype=torch.int32)
                stored = self._rows_for_storage(rows)
            t = torch.as_tensor(tgt, device=self.device)
            self.R[t] = stored
            self.sizes[t] = row_sizes
            self.live[t] = True
            self.dead -= k
            self.version += 1
        obs.counter("store.rows_replaced").add(k)
        self._ensure_room(0)

    def compact(self) -> np.ndarray | None:
        """Move the live rows to the arena head in place (their order
        kept: the oldest stay first, the FIFO order eviction relies on),
        reclaiming dead slots.  Returns the old -> new slot remap (-1
        for a reclaimed slot), or None when nothing was dead."""
        if self.dead == 0:
            return None
        keep = self._valid().cpu().numpy()
        kept = np.flatnonzero(keep)
        arena = self._arena
        step = max(1, CONVERT_BLOCK_ELEMS // max(arena.shape[1], 1))
        # a kept row only moves toward the head (kept[i] >= i), so each
        # block's sources are read before any later write reaches them
        for lo in range(0, kept.size, step):
            src = torch.as_tensor(kept[lo:lo + step], device=self.device)
            arena[lo:lo + src.numel()] = arena.index_select(0, src)
        arena[kept.size:] = self._fill_value()
        sizes = torch.zeros_like(self.sizes)
        sizes[:kept.size] = self.sizes[torch.as_tensor(kept,
                                                       device=self.device)]
        self.sizes = sizes
        remap = np.full(self.capacity, -1, np.int64)
        remap[kept] = np.arange(kept.size)
        self.count = int(kept.size)
        self.dead = 0
        self.live = torch.ones(self.capacity, dtype=torch.bool,
                               device=self.device)
        self.version += 1
        obs.counter("store.compactions").add(1)
        if self.track_remaps:
            self._remaps.append(remap)
        return remap

    def _compress_step(self) -> bool:
        """Morph the arena one step down the policy's ladder; True when
        a step was taken.  Stores with a fixed layout cannot morph."""
        return False

    def _ensure_room(self, incoming: int):
        """Enforce the pressure policy before a write of ``incoming``
        rows: reclaim dead slots first, then walk the codec ladder (each
        step shrinks the bytes a row, so a ``max_bytes`` cap admits more
        rows), and only then evict the oldest live rows until the batch
        fits.  ``incoming=0`` brings an arena whose rows grew wider back
        under the cap."""
        cap = self.row_cap
        if cap is None:
            return
        if self.count + incoming > cap and self.dead:
            self.compact()
        while self.count + incoming > cap and self._compress_step():
            cap = self.row_cap
        if incoming > cap:
            raise ValueError(
                f"batch of {incoming} rows exceeds the policy row cap "
                f"of {cap}")
        if self.count + incoming > cap:
            self.compact()
            over = self.count + incoming - cap
            if over > 0:
                evicted = self.kill_rows(
                    torch.arange(self.capacity, device=self.device) < over)
                obs.counter("store.rows_evicted").add(evicted)
                self.compact()
        if self.capacity > cap:
            self._shrink_rows(cap)

    def _shrink_rows(self, cap: int) -> None:
        """Cut the arena to ``cap`` rows once wider rows (a token
        widening) lowered the policy's row cap below the capacity, so
        capacity x row bytes stays within ``max_bytes``; every filled row
        lies below the cap (`_ensure_room` compacted and evicted first).
        The reference keeps the larger arena."""
        self._arena = self._arena[:cap].clone()
        self.sizes = self.sizes[:cap].clone()
        self.live = self.live[:cap].clone()
        self.capacity = cap
        self._idx_cache = None
        self.version += 1

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
                 policy: StorePressurePolicy | None = None, device=None):
        super().__init__(n, capacity=capacity, policy=policy, device=device)
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

    def _fill_value(self) -> int:
        return 0

    def _row_contrib(self, mask) -> torch.Tensor:
        """The counter contribution of the masked rows: the
        ``coverage_matvec`` kernel, exact (integer counts below 2**24)."""
        return kops.coverage_matvec(mask, self.R).to(torch.int32)

    def add_batch(self, visited, counter=None) -> np.ndarray:
        """Append ``visited (B, n)`` 0/1 rows in place with one
        ``arena_commit`` launch (the unfused write path), which counts
        the batch's columns itself: ``counter``, the sampler's equal
        contribution, is not needed.  Returns the slots the rows landed
        in.  Under a `StorePressurePolicy` the write may first compact
        and evict (`_ensure_room`)."""
        with obs.span("store.write", tier="store", kind="bitmap"):
            visited = visited.to(self.device)
            B = int(visited.shape[0])
            self._ensure_room(B)
            self._grow_rows(self.count + B)
            lo, hi = self.count, self.count + B
            self._commit(visited, self.R[lo:hi], self.sizes[lo:hi])
            self._note_write(B)
        return np.arange(lo, hi, dtype=np.int64)

    def view(self) -> StoreView:
        return StoreView("bitmap", self.R, self._valid(), self.n, self.count)

    def index_view(self, l_pad: int) -> StoreView:
        """The arena as C4 index lists ``(capacity, l_pad) int32``, cached
        until the arena next changes."""
        return _cached_index_view(self, l_pad, lambda lo, hi: self.R[lo:hi])

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
        cross-representation restore path; ``_restore_slots`` records
        the slot each row landed in (stream provenance follows it)."""
        store = cls(int(n), capacity=max(int(rows.shape[0]), MIN_CAPACITY),
                    device=device)
        store._restore_slots = (
            store.add_batch(torch.as_tensor(np.asarray(rows, np.uint8)))
            if rows.shape[0] else np.zeros((0,), np.int64))
        return store


class IndexStore(_ArenaBase):
    """Index-list arena: ``(capacity, l_pad) int32`` rows of ascending
    member ids, sentinel ``n``.  ``l_pad`` widens by powers of two when a
    batch holds a larger set (new columns are sentinel, so old rows keep
    their meaning); bitmap batches are converted on write, so resident
    memory is O(theta * L), not O(theta * n)."""

    representation = "indices"

    def __init__(self, n: int, *, capacity: int = MIN_CAPACITY,
                 l_pad: int = MIN_INDEX_PAD,
                 policy: StorePressurePolicy | None = None, device=None):
        super().__init__(n, capacity=capacity, policy=policy, device=device)
        self.l_pad = next_pow2(l_pad, MIN_INDEX_PAD)
        self._arena = self._new_arena(self.capacity, self.l_pad)

    def _new_arena(self, capacity: int, l_pad: int) -> torch.Tensor:
        return torch.full((capacity, l_pad), self.n, dtype=torch.int32,
                          device=self.device)

    @property
    def R(self) -> torch.Tensor:
        return self._arena

    def _realloc(self, new_cap: int):
        arena = self._new_arena(new_cap, self.l_pad)
        arena[:self.capacity] = self._arena
        self._arena = arena

    def _widen(self, l_need: int):
        new_l = next_pow2(l_need, self.l_pad)
        if new_l == self.l_pad:
            return
        arena = self._new_arena(self.capacity, new_l)
        arena[:, :self.l_pad] = self._arena
        self._arena = arena
        self.l_pad = new_l

    def _row_bytes(self) -> int:
        return 4 * self.l_pad

    def _fill_value(self) -> int:
        return self.n

    def _rows_for_storage(self, rows):
        self._widen(int(rows.sum(dim=1, dtype=torch.int32).max()))
        return bitmap_to_indices(rows, self.l_pad)

    def _row_contrib(self, mask) -> torch.Tensor:
        """The counter contribution of the masked rows: their members
        scattered (the sentinel dropped)."""
        return bincount_weighted(self.R, mask[:, None].to(torch.int32),
                                 self.n)

    def add_batch(self, visited, counter=None) -> np.ndarray:
        """Convert and append ``visited (B, n)`` 0/1 rows, widening to the
        batch's largest set first; returns the slots they landed in."""
        with obs.span("store.write", tier="store", kind="indices"):
            visited = visited.to(self.device, torch.uint8)
            B = int(visited.shape[0])
            batch_sizes = visited.sum(dim=1, dtype=torch.int32)
            self._widen(int(batch_sizes.max()))
            self._ensure_room(B)
            self._grow_rows(self.count + B)
            if counter is None:
                counter = visited.sum(dim=0, dtype=torch.int32)
            slots = np.arange(self.count, self.count + B, dtype=np.int64)
            bitmap_to_indices(visited, self.l_pad,
                              out=self.R[self.count:self.count + B])
            self._finish_add(batch_sizes, counter)
        return slots

    def add_index_batch(self, rows, counter=None) -> np.ndarray:
        """Append index rows ``(B, L) int32`` (ascending, sentinel >= n),
        the sparse sampler's native emission: no ``(B, n)`` bitmap lies
        between the sampler and the arena.  ``counter`` is the sampler's
        ``(n,) int32`` contribution (a scatter of the rows when absent);
        the arena widens to ``L`` if needed, narrower rows pad with the
        sentinel.  Returns the slots, as `add_batch` does."""
        with obs.span("store.write", tier="store", kind="indices"):
            rows = torch.as_tensor(rows).to(self.device, torch.int32)
            B, L = int(rows.shape[0]), int(rows.shape[1])
            batch_sizes = (rows < self.n).sum(dim=1, dtype=torch.int32)
            self._widen(L)
            # any emitter sentinel (>= n) becomes the store's (== n)
            rows = torch.where(rows < self.n, rows, self.n)
            self._ensure_room(B)
            self._grow_rows(self.count + B)
            if counter is None:
                counter = bincount_weighted(
                    rows, torch.ones((), dtype=torch.int32,
                                     device=self.device), self.n)
            lo, hi = self.count, self.count + B
            slots = np.arange(lo, hi, dtype=np.int64)
            self.R[lo:hi, :L] = rows
            self.R[lo:hi, L:] = self.n
            self._finish_add(batch_sizes, counter)
        return slots

    def view(self) -> StoreView:
        return StoreView("indices", self.R, self._valid(), self.n, self.count)

    def hits(self, S) -> torch.Tensor:
        """Covered fraction per query: ``S (Q, L) int`` -> ``(Q,) f32``."""
        with obs.span("count", tier="store", kind="indices"):
            S = torch.as_tensor(np.asarray(S, np.int64), device=self.device)
            return _index_hits(self.R, self._valid(), S, self.n)

    def state(self) -> dict:
        """Host snapshot: the ``(capacity, l_pad)`` lists plus counters
        (kind tag ``"indices"``), the reference's format."""
        st = self._base_state()
        st["kind"] = np.asarray("indices")
        st["R"] = self.R.cpu().numpy()
        return st

    @classmethod
    def from_state(cls, st, *, device=None) -> "IndexStore":
        R = np.asarray(st["R"], np.int32)
        store = cls(int(st["n"]), capacity=R.shape[0], l_pad=R.shape[1],
                    device=device)
        if store.R.shape != R.shape:
            raise ValueError(f"snapshot index arena {R.shape} is not a "
                             f"power of two >= {MIN_CAPACITY} rows by a "
                             f"power of two >= {MIN_INDEX_PAD} columns")
        store.R.copy_(torch.from_numpy(np.require(R, None, ("C", "W"))))
        store._restore_base(st)
        return store


# ------------------------------------------------------- sharded (C1) ----

#: what the row lifecycle, the pressure policy and the meshed stream and
#: serving layers wait for
A8B = "the meshed row lifecycle and streaming (ROADMAP A8b)"


def _tile_codec(kind: str, n_cols: int, s_pad=None):
    """Per-tile codec of a meshed arena (``bitmap``/``packed``/
    ``compressed`` over a tile's ``n_cols`` columns)."""
    from repro_torch.core.pack.codec import MIN_TOKEN_PAD, codec_for
    return codec_for(kind, n_cols,
                     MIN_TOKEN_PAD if s_pad is None else int(s_pad))


@dataclasses.dataclass(frozen=True)
class BatchPlacement:
    """Where a meshed store wants a batch's rows: theta shard ``t``
    samples and holds rows ``[t * b, (t + 1) * b)`` (``b = ceil(B /
    Dt)``, the last blocks cut at ``B``) on ``devices[t]``, the device
    of its first vertex tile."""
    devices: tuple

    def blocks(self, batch: int) -> list:
        """``[(device, lo, hi)]`` of each theta shard's row block of a
        ``batch``-row batch (``lo == hi`` for a shard past its end)."""
        D = len(self.devices)
        b = -(-int(batch) // D)
        return [(dev, min(t * b, batch), min((t + 1) * b, batch))
                for t, dev in enumerate(self.devices)]


class ShardedStore:
    """Mesh-sharded RRR arena — the paper's C1 partitioning applied to
    the store (``repro.core.store.ShardedStore``), over a 1D (theta) or
    2D (theta x vertex) `repro_torch.mesh.Mesh`.

    Layout over ``D`` theta shards and ``Dv`` vertex shards, the
    reference's:

      * tile ``(t, v)`` is its own tensor on
        ``mesh.tile_devices(...)[t][v]``: rows ``[t * cap_local, (t+1) *
        cap_local)`` of the global slot space by the ``n_local =
        partition.block`` columns of vertex block ``v`` (``n_pad = Dv *
        n_local``; pad columns stay zero), encoded by the tile codec
        (``bitmap``, ``packed`` or ``compressed``), rows at a 16-byte
        stride so the kernels read them with 16-byte loads;
      * ``cap_local`` is a power of two, grown per shard by doubling;
      * counter partials ``(Dt, n_pad)`` (tile ``(t, v)`` counts its own
        rows over its own columns), ``sizes`` per theta shard (on the
        shard's first tile's device), per-shard row counts with a host
        mirror.

    ``add_batch`` splits a batch into ``ceil(B / D)``-row blocks and
    ``Dv`` column blocks; every bitmap or packed tile writes its block
    with one ``arena_commit`` launch (the counter partial and the row
    sums fused; on a 2D mesh a row's size is the sum over its vertex
    tiles), token tiles are encoded in PyTorch.  A batch a sampler
    placed (`batch_placement`) arrives as one row block per theta shard.
    Global slots are ``t * cap_local + counts[t] + i``, the reference's.

    Reads hand the tiles over: ``view()`` is a `StoreView` whose ``R``
    is the ``[Dt][Dv]`` grid of tile views and whose ``valid`` holds one
    row mask per theta shard — the sharded selections consume them in
    place, and no concatenation of the arena is ever made.  Selection,
    ``hits`` and the counter are permutation-invariant over rows and
    exact integer sums over columns, so a store fed the batches of a
    `BitmapStore` answers bitwise as it does on any mesh shape.

    ``state``/``from_state`` are elastic: a snapshot holds the valid
    rows compacted in shard order, decoded and in global vertex order
    (kind ``"sharded"``, the reference's format), so it restores onto
    any layout — none, 1D or 2D, equal or balanced, any codec.

    The row lifecycle (``kill_rows``, ``replace_rows``, ``compact``),
    a `StorePressurePolicy` and slot remaps raise `NotImplementedError`
    (ROADMAP A8b).
    """

    #: rows a restore feeds per `add_batch` (bounds the host -> device
    #: staging, as in the reference)
    RESTORE_CHUNK = 4096

    def __init__(self, n: int, *, mesh, theta_axes=("data",),
                 vertex_axis=None, capacity: int = MIN_CAPACITY,
                 policy: StorePressurePolicy | None = None,
                 partition=None, codec: str = "bitmap", s_pad=None):
        if mesh is None:
            raise ValueError("ShardedStore needs a repro_torch.mesh.Mesh")
        if policy is not None:
            raise NotImplementedError(
                f"a StorePressurePolicy on a sharded store: {A8B}")
        if isinstance(theta_axes, str):
            theta_axes = (theta_axes,)
        self.n = int(n)
        self.mesh = mesh
        self.theta_axes = tuple(theta_axes)
        self.vertex_axis = vertex_axis
        self.devices = mesh.tile_devices(self.theta_axes, vertex_axis)
        for dev in mesh.distinct_devices():
            resolve_device(dev)
        self.D, self.Dv = len(self.devices), len(self.devices[0])
        if partition is None:
            partition = vertex_partition(self.n, self.Dv)
        elif partition.n != self.n or partition.shards != self.Dv:
            raise ValueError(
                f"partition covers n={partition.n} over {partition.shards} "
                f"shards; this store needs n={self.n} over Dv={self.Dv}")
        self.partition = partition
        self.n_local, self.n_pad = partition.block, partition.n_pad
        #: first global vertex and live column count of each vertex tile
        self.col_lo = [int(s) for s in partition.starts[:-1]]
        self.col_width = [int(w) for w in partition.sizes]
        self.codec = _tile_codec(codec, self.n_local, s_pad)
        self.cap_local = next_pow2(-(-int(capacity) // self.D))
        self.version = 0
        self.policy = None
        self.track_remaps = False
        self._counts_host = np.zeros((self.D,), np.int64)
        self._tiles = [[self._new_tile(t, v, self.cap_local)
                        for v in range(self.Dv)] for t in range(self.D)]
        self._sizes = [torch.zeros(self.cap_local, dtype=torch.int32,
                                   device=self._home(t))
                       for t in range(self.D)]
        self._counter = [[torch.zeros(self.n_local, dtype=torch.int32,
                                      device=self.devices[t][v])
                          for v in range(self.Dv)] for t in range(self.D)]
        # on a vertex axis, each tile's row sums (the sets' local sizes,
        # the per-shard C4 statistic) as its writes count them
        self._tile_sizes = [[torch.zeros(self.cap_local, dtype=torch.int32,
                                         device=self.devices[t][v])
                             for v in range(self.Dv)]
                            for t in range(self.D)] if self.Dv > 1 else None
        self._idx_cache = None       # ((version, l_pad), index tiles)
        self._localmax_cache = None  # (version, max local set size)

    # ------------------------------------------------------------ shape ----

    def _home(self, t: int) -> torch.device:
        """Device of theta shard ``t``'s sizes, row mask and batch rows."""
        return self.devices[t][0]

    @property
    def device(self) -> torch.device:
        """The first tile's device (where global reductions land)."""
        return self.devices[0][0]

    @property
    def row_stride(self) -> int:
        """Elements per tile row: the codec width padded to 16 bytes."""
        item = torch.empty((), dtype=self.codec.dtype).element_size()
        return padded_width(self.codec.width * item) // item

    def _new_tile(self, t: int, v: int, rows: int) -> torch.Tensor:
        return torch.full((rows, self.row_stride), self.codec.fill,
                          dtype=self.codec.dtype, device=self.devices[t][v])

    def tile(self, t: int, v: int) -> torch.Tensor:
        """Tile ``(t, v)``'s ``(cap_local, codec.width)`` view."""
        return self._tiles[t][v][:, :self.codec.width]

    @property
    def representation(self) -> str:
        """The tile codec's kind: what the engine dispatches on."""
        return self.codec.kind

    @property
    def capacity(self) -> int:
        """Global row capacity (``D * cap_local``)."""
        return self.D * self.cap_local

    @property
    def count(self) -> int:
        """Total stored RRR sets across all shards."""
        return int(self._counts_host.sum())

    @property
    def counts(self) -> np.ndarray:
        """Per-shard valid row counts ``(D,)`` (a host copy)."""
        return self._counts_host.copy()

    @property
    def arena_bytes(self) -> int:
        """Device bytes of every tile, row padding included."""
        return sum(self.tile_bytes())

    def tile_bytes(self) -> list:
        """Bytes of each tile, in ``(t, v)`` row-major order."""
        return [x.numel() * x.element_size()
                for row in self._tiles for x in row]

    @property
    def batch_placement(self) -> BatchPlacement:
        """The placement a sampler samples its batches under, so each
        theta shard's rows are born on the shard's device."""
        return BatchPlacement(tuple(self._home(t) for t in range(self.D)))

    @property
    def sizes(self) -> torch.Tensor:
        """``(capacity,) int32`` set sizes in global slot order, gathered
        on the first tile's device (host and reporting use)."""
        return mesh_ops.all_gather(self._sizes, self.device).reshape(-1)

    @property
    def counter(self) -> torch.Tensor:
        """Global fused counter ``(n,) int32`` in global vertex order: the
        partials reduced over the theta axis, pad columns stripped."""
        return torch.cat([
            mesh_ops.psum([self._counter[t][v] for t in range(self.D)],
                          self.device)[:self.col_width[v]]
            for v in range(self.Dv)])

    # ---------------------------------------------------------- writing ----

    def _grow_rows(self, incoming: int):
        need = int(self._counts_host.max(initial=0)) + int(incoming)
        new_cap = next_pow2(need, self.cap_local)
        if new_cap == self.cap_local:
            return
        pad = new_cap - self.cap_local
        for t in range(self.D):
            for v in range(self.Dv):
                tile = self._new_tile(t, v, new_cap)
                tile[:self.cap_local] = self._tiles[t][v]
                self._tiles[t][v] = tile
            self._sizes[t] = torch.cat([self._sizes[t], torch.zeros(
                pad, dtype=torch.int32, device=self._home(t))])
            for v in range(self.Dv if self._tile_sizes else 0):
                self._tile_sizes[t][v] = torch.cat([
                    self._tile_sizes[t][v], torch.zeros(
                        pad, dtype=torch.int32, device=self.devices[t][v])])
        self.cap_local = new_cap

    def _row_blocks(self, visited) -> list:
        """One row block per theta shard: a placed batch (a sequence of
        ``D`` blocks) as it is, a ``(B, n)`` batch cut by
        `batch_placement`."""
        if isinstance(visited, (list, tuple)):
            blocks = [torch.as_tensor(b) for b in visited]
            if len(blocks) != self.D:
                raise ValueError(f"a placed batch has {len(blocks)} row "
                                 f"blocks; this store has {self.D} shards")
            got = [int(b.shape[0]) for b in blocks]
            want = [hi - lo for _, lo, hi in
                    self.batch_placement.blocks(sum(got))]
            if got != want:
                raise ValueError(f"placed blocks of {got} rows; a batch of "
                                 f"{sum(got)} splits as {want}")
            return blocks
        visited = torch.as_tensor(visited)
        return [visited[lo:hi] for _, lo, hi in
                self.batch_placement.blocks(int(visited.shape[0]))]

    def _tile_cols(self, block, t: int, v: int) -> torch.Tensor:
        """Tile ``(t, v)``'s columns of a row block, on its device: one
        contiguous run in either layout (blocks are ascending)."""
        lo = self.col_lo[v]
        return block[:, lo:lo + self.col_width[v]].to(self.devices[t][v])

    def _tile_bits(self, block, t: int, v: int) -> torch.Tensor:
        """A row block's ``(k, n_local)`` uint8 bits for tile ``(t, v)``,
        pad columns zero (what a token tile encodes)."""
        cols = self._tile_cols(block, t, v)
        bits = torch.zeros((cols.shape[0], self.n_local), dtype=torch.uint8,
                           device=cols.device)
        bits[:, :cols.shape[1]] = cols
        return bits

    def _widen_tokens(self, blocks) -> None:
        """Grow the token tiles' ``s_pad`` (a power of two) to hold the
        most tokens any row of ``blocks`` needs in any vertex tile; the
        wider tiles keep every row (new columns are sentinel)."""
        from repro_torch.core.pack.codec import (
            MIN_TOKEN_PAD, TokenCodec, tokens_needed)
        need = 0
        for t, block in enumerate(blocks):
            for v in range(self.Dv if block.shape[0] else 0):
                need = max(need, int(tokens_needed(
                    self._tile_bits(block, t, v)).max()))
        s_new = next_pow2(max(need, MIN_TOKEN_PAD), self.codec.s_pad)
        if s_new == self.codec.s_pad:
            return
        old = [[self.tile(t, v) for v in range(self.Dv)]
               for t in range(self.D)]
        self.codec = TokenCodec(self.n_local, s_new)
        for t in range(self.D):
            for v in range(self.Dv):
                self._tiles[t][v] = self._new_tile(t, v, self.cap_local)
                self._tiles[t][v][:, :old[t][v].shape[1]] = old[t][v]
        self._idx_cache = None
        self.version += 1

    def _write_tile(self, t: int, v: int, lo: int, block, sizes) -> None:
        """Write tile ``(t, v)``'s columns of a row block at local row
        ``lo``: the block's column sums into the tile's counter partial,
        its row sums into ``sizes``."""
        kind = self.codec.kind
        counter = self._counter[t][v]
        if kind in kops.COMMIT_KINDS:
            cols = self._tile_cols(block, t, v)
            k, w = cols.shape
            width = w if kind == "bitmap" else -(-w // 8)
            out = self._tiles[t][v][lo:lo + k, :width]
            kops.arena_commit(kops.commit_rows(cols), out, counter[:w],
                              kind=kind, sizes=sizes)
        else:
            bits = self._tile_bits(block, t, v)
            k = bits.shape[0]
            self._tiles[t][v][lo:lo + k, :self.codec.width] = \
                self.codec.encode(bits)
            counter += bits.sum(dim=0, dtype=torch.int32)
            sizes.copy_(bits.sum(dim=1, dtype=torch.int32))

    def add_batch(self, visited, counter=None) -> np.ndarray:
        """Append ``visited (B, n)`` 0/1 rows (or a placed batch: one row
        block per theta shard), block-split across the tiles.  ``counter``
        is not needed: each tile counts its own block.  Returns the
        global slot of each batch row."""
        del counter
        with obs.span("store.write", tier="store", kind="sharded"):
            blocks = self._row_blocks(visited)
            B = sum(int(b.shape[0]) for b in blocks)
            if B == 0:
                return np.zeros((0,), np.int64)
            if self.codec.kind == "compressed":
                self._widen_tokens(blocks)
            b = -(-B // self.D)
            self._grow_rows(b)
            slots = np.empty((B,), np.int64)
            for t, block in enumerate(blocks):
                k = int(block.shape[0])
                if k == 0:
                    continue
                c = int(self._counts_host[t])
                slots[t * b:t * b + k] = t * self.cap_local + c + np.arange(k)
                home = self._sizes[t][c:c + k]
                if self.Dv == 1:
                    self._write_tile(t, 0, c, block, home)
                else:
                    parts = [self._tile_sizes[t][v][c:c + k]
                             for v in range(self.Dv)]
                    for v, part in enumerate(parts):
                        self._write_tile(t, v, c, block, part)
                    home.copy_(mesh_ops.psum(parts, home.device))
                self._counts_host[t] += k
            self._note_write(B)
        return slots

    def _note_write(self, B: int) -> None:
        self.version += 1
        if obs.enabled():
            obs.counter("store.rows_written").add(int(B))
            obs.gauge("store.occupancy").set(self.count / self.capacity)
            obs.gauge("store.arena_bytes").set(self.arena_bytes)
            obs.gauge("store.bytes_per_device").set(max(self.tile_bytes()))

    # ----------------------------------------------------- row lifecycle ----

    def kill_rows(self, dead) -> int:
        raise NotImplementedError(f"kill_rows on a sharded store: {A8B}")

    def replace_rows(self, idx, rows) -> None:
        raise NotImplementedError(f"replace_rows on a sharded store: {A8B}")

    def compact(self):
        raise NotImplementedError(f"compact on a sharded store: {A8B}")

    def drain_remaps(self) -> list:
        raise NotImplementedError(f"slot remaps of a sharded store: {A8B}")

    def _compress_step(self) -> bool:
        raise NotImplementedError(
            f"the codec ladder on a sharded store: {A8B}")

    # ---------------------------------------------------------- reading ----

    def valid_mask(self) -> tuple:
        """One ``(cap_local,) bool`` mask of the filled rows per theta
        shard, on the shard's device (every row lives until the meshed
        row lifecycle, A8b)."""
        return tuple(
            torch.arange(self.cap_local, device=self._home(t))
            < int(self._counts_host[t]) for t in range(self.D))

    def view(self) -> StoreView:
        """The tiles in place: ``R`` is the ``[Dt][Dv]`` grid of tile
        views, ``valid`` one row mask per theta shard."""
        grid = tuple(tuple(self.tile(t, v) for v in range(self.Dv))
                     for t in range(self.D))
        return StoreView(self.representation, grid, self.valid_mask(),
                         self.n, self.count)

    def _member_parts(self, t: int, verts) -> list:
        """Per vertex tile of theta shard ``t``: ``(cap_local, L) bool``
        membership of the global vertices ``verts (L,)`` that fall in
        the tile's block (False for the others)."""
        parts = []
        for v in range(self.Dv):
            lidx = verts.to(self.devices[t][v]) - self.col_lo[v]
            ok = (lidx >= 0) & (lidx < self.col_width[v])
            memb = self.codec.decode_cols(
                self.tile(t, v), lidx.clamp(0, self.n_local - 1))
            parts.append(memb & ok[None, :])
        return parts

    def hits(self, S) -> torch.Tensor:
        """Covered fraction per query: ``S (Q, L) int`` -> ``(Q,) f32``.
        Each tile tests the queried vertices inside its own block against
        its own rows; hit bits or over the vertex axis, counts sum over
        the theta axis."""
        with obs.span("count", tier="store", kind="sharded"):
            S = torch.as_tensor(np.asarray(S, np.int64))
            Q, L = S.shape
            valid = self.valid_mask()
            counts, n_valid = [], []
            for t in range(self.D):
                parts = [m.view(-1, Q, L).any(dim=2)
                         for m in self._member_parts(t, S.reshape(-1))]
                hit = mesh_ops.psum_or(parts, self._home(t)) \
                    & valid[t][:, None]
                counts.append(hit.sum(dim=0, dtype=torch.int32))
                n_valid.append(valid[t].sum(dtype=torch.int32))
            hits = mesh_ops.psum(counts, self.device).to(torch.float32)
            nv = mesh_ops.psum(n_valid, self.device).to(torch.float32)
            return hits / nv.clamp_min(1.0)

    def rows_touching_cols(self, verts, vmask) -> torch.Tensor:
        """``(capacity,) bool`` rows holding any of the masked global
        vertices ``verts`` — the streaming reverse-touch query, tile-local
        in both axes (hit bits or over the vertex axis)."""
        verts = torch.as_tensor(np.asarray(verts, np.int64))
        vmask = torch.as_tensor(np.asarray(vmask, bool))
        out = []
        for t in range(self.D):
            parts = [(m & vmask.to(m.device)[None, :]).any(dim=1)
                     for m in self._member_parts(t, verts)]
            out.append(mesh_ops.psum_or(parts, self._home(t)))
        return mesh_ops.all_gather(out, self.device).reshape(-1)

    def coverage_stats(self) -> tuple[float, int]:
        """(avg fractional set coverage, max set size) over stored sets."""
        return _coverage_stats(self.sizes, self.count, self.n)

    def max_local_size(self) -> int:
        """Max per-vertex-shard set size over valid rows — the statistic
        the per-shard C4 choice keys on — from the row sums the tiles'
        writes counted (no pass over the arena); cached per store
        version."""
        if (self._localmax_cache is not None
                and self._localmax_cache[0] == self.version):
            return self._localmax_cache[1]
        valid = self.valid_mask()
        tiles = ([[s] for s in self._sizes] if self._tile_sizes is None
                 else self._tile_sizes)
        sizes = [(sz * valid[t].to(sz.device)).max()
                 for t, row in enumerate(tiles) for sz in row]
        best = int(mesh_ops.all_gather(sizes, self.device).max())
        self._localmax_cache = (self.version, best)
        return best

    def index_view(self, l_pad: int) -> StoreView:
        """C4 index view: each tile's rows as ``(cap_local, l_pad)`` lists
        of *local* ids (sentinel ``n_local``), converted a block of rows
        at a time on the tile's device; cached until the arena changes."""
        key = (self.version, int(l_pad))
        if self._idx_cache is None or self._idx_cache[0] != key:
            self._idx_cache = None
            step = max(1, CONVERT_BLOCK_ELEMS // max(self.n_local, 1))
            grid = []
            for t in range(self.D):
                row = []
                for v in range(self.Dv):
                    tile = self.tile(t, v)
                    out = torch.empty((self.cap_local, int(l_pad)),
                                      dtype=torch.int32, device=tile.device)
                    for lo in range(0, self.cap_local, step):
                        bitmap_to_indices(self.codec.decode(
                            tile[lo:lo + step]), int(l_pad),
                            out=out[lo:lo + step])
                    row.append(out)
                grid.append(tuple(row))
            self._idx_cache = (key, tuple(grid))
        return StoreView("indices", self._idx_cache[1], self.valid_mask(),
                         self.n, self.count)

    # ------------------------------------------------------ checkpointing ----

    def state(self) -> dict:
        """Host snapshot (kind ``"sharded"``, the reference's format): the
        valid rows of every shard compacted in shard order, decoded per
        tile and put back in global vertex order, so any layout restores
        it; ``rep`` names the tile codec."""
        rows, sizes = [], []
        for t in range(self.D):
            c = int(self._counts_host[t])
            if c == 0:
                continue
            rows.append(np.concatenate(
                [self.codec.decode_np(self.tile(t, v)[:c].cpu().numpy())
                 [:, :self.col_width[v]] for v in range(self.Dv)], axis=1))
            sizes.append(self._sizes[t][:c].cpu().numpy())
        return {
            "kind": np.asarray("sharded"),
            "rep": np.asarray(self.codec.kind),
            "n": np.int64(self.n),
            "count": np.int64(self.count),
            "R": (np.concatenate(rows).astype(np.uint8, copy=False) if rows
                  else np.zeros((0, self.n), np.uint8)),
            "sizes": (np.concatenate(sizes) if sizes
                      else np.zeros((0,), np.int32)),
            "counter": self.counter.cpu().numpy(),
        }

    @classmethod
    def from_state(cls, st, *, mesh, theta_axes=("data",),
                   vertex_axis=None, partition=None,
                   codec: str = "bitmap") -> "ShardedStore":
        """Rebuild on ``mesh`` from any row snapshot (sharded, bitmap,
        packed, compressed): the live rows are fed ``RESTORE_CHUNK`` at a
        time, spread block-evenly over the tiles and encoded by
        ``codec``; counter and sizes are recounted (equal to the saved
        ones).  ``_restore_slots`` records the slot of each row."""
        n, rows = _live_rows_from_state(st)
        store = cls(n, mesh=mesh, theta_axes=theta_axes,
                    vertex_axis=vertex_axis, capacity=max(len(rows), 1),
                    partition=partition, codec=codec)
        chunk = max(cls.RESTORE_CHUNK // store.D, 1) * store.D
        slots = [store.add_batch(torch.from_numpy(
                     np.ascontiguousarray(rows[lo:lo + chunk], np.uint8)))
                 for lo in range(0, len(rows), chunk)]
        store._restore_slots = (np.concatenate(slots) if slots
                                else np.zeros((0,), np.int64))
        return store


_KINDS = ("bitmap", "packed", "compressed", "indices")
_ROW_KINDS = ("bitmap", "packed", "compressed")

#: single-device store classes by kind; ``repro_torch.core.pack.stores``
#: registers ``packed`` and ``compressed`` when it is imported
STORE_KINDS = {"bitmap": BitmapStore, "indices": IndexStore}


def _store_class(kind: str):
    """The single-device store class of ``kind`` (``auto`` is bitmap)."""
    kind = "bitmap" if kind == "auto" else kind
    if kind in ("packed", "compressed") and kind not in STORE_KINDS:
        from repro_torch.core.pack import stores  # noqa: F401 (registers)
    if kind in STORE_KINDS:
        return STORE_KINDS[kind]
    raise ValueError(f"unknown store kind {kind!r}; have "
                     f"{sorted(_KINDS + ('sharded',))}")


def make_store(kind: str, n: int, *, device=None, **kw):
    """Store factory: ``"auto"``/``"bitmap"`` give a `BitmapStore`,
    ``"indices"`` an `IndexStore`, ``"packed"`` a `PackedBitmapStore`,
    ``"compressed"`` a `CompressedStore`, ``"sharded"`` a `ShardedStore`
    (``mesh=`` required; ``theta_axes=``, ``vertex_axis=``,
    ``partition=`` and the tile ``codec=``; its devices are the mesh's);
    ``policy=`` (a `StorePressurePolicy`) and the constructors' other
    keywords pass through."""
    if kind == "sharded":
        if device is not None:
            raise ValueError("a sharded store's devices are its mesh's; "
                             "build the mesh on the device instead")
        return ShardedStore(n, **kw)
    return _store_class(kind)(n, device=device, **kw)


def _live_rows_from_state(st) -> tuple[int, np.ndarray]:
    """Decode a bitmap, packed, compressed or sharded snapshot to its
    live bit rows: ``(n, (live rows, n) uint8)`` — the
    cross-representation interchange form that any store's
    ``from_rows`` re-encodes (a sharded snapshot's rows are that form
    already)."""
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


def store_from_state(st, *, device=None, kind: str = None, mesh=None,
                     theta_axes=("data",), vertex_axis=None,
                     partition=None):
    """Rebuild a store from a `state()` tree.  ``kind`` picks the target
    representation (None keeps the snapshot's own; a ``"sharded"``
    snapshot's own is its ``rep`` tag): the same kind restores the arena
    in place, another kind re-encodes the snapshot's live rows
    (`from_rows`), so bitmap, packed, compressed and sharded snapshots
    each restore into any of the three; an index snapshot restores only
    as an `IndexStore`, and only an index snapshot does (lists are not
    re-encoded, as in the reference).  With ``mesh`` the result is a
    `ShardedStore` whose tiles use the target codec (any layout restores
    any snapshot but an index one)."""
    snap_kind = str(np.asarray(st["kind"]))
    default = snap_kind
    if snap_kind == "sharded":
        default = str(np.asarray(st["rep"])) if "rep" in st else "bitmap"
    target = default if kind is None else kind
    for k in (snap_kind, target):
        if k not in _KINDS + ("sharded",):
            raise ValueError(f"unknown store kind {k!r}")
    if mesh is not None:
        if "indices" in (snap_kind, target):
            raise ValueError(
                f"cannot restore a {snap_kind!r} snapshot as {target!r} on "
                f"a mesh: a meshed arena is {_ROW_KINDS} tiles (its index "
                f"lists are a derived index_view)")
        return ShardedStore.from_state(
            st, mesh=mesh, theta_axes=theta_axes, vertex_axis=vertex_axis,
            partition=partition,
            codec=target if target in _ROW_KINDS else "bitmap")
    if target == "sharded":
        raise ValueError(
            "target representation 'sharded' needs a mesh= argument")
    if "indices" in (snap_kind, target) and snap_kind != target:
        raise ValueError(
            f"cannot restore a {snap_kind!r} snapshot as {target!r}: "
            f"{_ROW_KINDS} each restore from any of them, 'indices' only "
            f"from an 'indices' snapshot")
    cls = _store_class(target)
    if target == snap_kind:
        return cls.from_state(st, device=device)
    n, rows = _live_rows_from_state(st)
    return cls.from_rows(rows, n, device=device)
