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
lifecycle and pressure policy run tile by tile (each tile's kills
through its codec's counter kernel, its repairs through
``arena_commit``), with one live mask per theta shard.
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
    ``row_cap``), ``rows_touching(verts)``, the ``(capacity,) bool``
    rows holding any of the unique global vertices ``verts``, and
    ``state_slots()``, the host ``(capacity,) bool`` mask of the slots
    whose rows ``state()`` holds, in its row order."""
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
    def rows_touching(self, verts) -> torch.Tensor: ...
    def coverage_stats(self) -> tuple[float, int]: ...
    def state(self) -> dict: ...
    def state_slots(self) -> np.ndarray: ...


def _compact_rows(arena, kept: np.ndarray, fill) -> None:
    """Move ``arena``'s rows ``kept`` (ascending) to its head in place, a
    block of rows at a time, and fill the rows after them."""
    step = max(1, CONVERT_BLOCK_ELEMS // max(arena.shape[1], 1))
    # a kept row only moves toward the head (kept[i] >= i), so each
    # block's sources are read before any later write reaches them
    for lo in range(0, kept.size, step):
        src = torch.as_tensor(kept[lo:lo + step], device=arena.device)
        arena[lo:lo + src.numel()] = arena.index_select(0, src)
    arena[kept.size:] = fill


def _compact_vec(vec, kept: np.ndarray):
    """``vec``'s entries ``kept`` at its head, zeros after them."""
    out = torch.zeros_like(vec)
    out[:kept.size] = vec[torch.as_tensor(kept, device=vec.device)]
    return out


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

    def state_slots(self) -> np.ndarray:
        """Every slot: ``state()`` holds the whole arena, dead rows and
        all."""
        return np.ones(self.capacity, bool)

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
        kept = np.flatnonzero(self._valid().cpu().numpy())
        _compact_rows(self._arena, kept, self._fill_value())
        self.sizes = _compact_vec(self.sizes, kept)
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

    def rows_touching(self, verts) -> torch.Tensor:
        """Rows whose traversal touched any of ``verts``: a gather of the
        touched columns."""
        v = torch.as_tensor(np.asarray(verts, np.int64), device=self.device)
        return (self.R.index_select(1, v) > 0).any(dim=1)

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

    def rows_touching(self, verts) -> torch.Tensor:
        """Rows listing any of ``verts``: a vertex mask gathered at every
        list entry (the sentinel ``n`` never matches)."""
        R = self.R
        mask = torch.zeros(self.n + 1, dtype=torch.bool, device=R.device)
        mask[torch.as_tensor(np.asarray(verts, np.int64),
                             device=R.device)] = True
        return mask.index_select(0, R.reshape(-1).long()).view(
            R.shape).any(dim=1)

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
    of its first vertex tile.  On a 2D mesh ``tiles`` is the store's
    ``[Dt][Dv]`` grid of tile devices and ``partition`` its vertex
    blocks: the dense samplers then column-block their BFS over them."""
    devices: tuple
    tiles: tuple = None
    partition: object = None

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
      * ``cap_local`` is a power of two, grown per shard by doubling
        (under a `StorePressurePolicy` it is clamped to the per-shard
        cap ``row_cap // D``, which need not be one);
      * counter partials ``(Dt, n_pad)`` (tile ``(t, v)`` counts its own
        rows over its own columns), ``sizes`` and the live bits per theta
        shard (on the shard's first tile's device, the live bits with a
        host mirror), per-shard row counts with a host mirror.

    ``add_batch`` splits a batch into ``ceil(B / D)``-row blocks and
    ``Dv`` column blocks; every bitmap or packed tile writes its block
    with one ``arena_commit`` launch (the counter partial and the row
    sums fused; on a 2D mesh a row's size is the sum over its vertex
    tiles), token tiles are encoded in PyTorch.  A batch a sampler
    placed (`batch_placement`) arrives as one row block per theta shard.
    Global slots are ``t * cap_local + counts[t] + i``, the reference's.

    Reads hand the tiles over: ``view()`` is a `StoreView` whose ``R``
    is the ``[Dt][Dv]`` grid of tile views and whose ``valid`` holds one
    row mask per theta shard (filled and live) — the sharded selections
    consume them in place, and no concatenation of the arena is ever
    made.  Selection, ``hits`` and the counter are permutation-invariant
    over rows and exact integer sums over columns, so a store fed the
    batches of a `BitmapStore` answers bitwise as it does on any mesh
    shape.

    The **row lifecycle** runs tile by tile, and nothing row-sized
    crosses tiles: ``kill_rows`` subtracts each tile's dead rows from its
    own counter partial through the tile codec's counter
    (``coverage_matvec``, ``packed_count`` or ``token_count``);
    ``replace_rows`` writes each tile's column slice of the targets in
    its theta block (bitmap and packed tiles through ``arena_commit``,
    token tiles widened first); ``compact`` moves each shard's live rows
    to the head of its block and returns the global remap.  Under a
    `StorePressurePolicy` each shard holds at most ``row_cap // D`` rows:
    a write compacts, then walks the codec ladder (the tiles decoded and
    re-encoded tile by tile), then evicts each over-full shard's oldest
    rows.  Growth renumbers the global slots (``t * cap + i`` becomes
    ``t * new_cap + i``), and ``drain_remaps`` hands every renumbering,
    growth and compaction alike, to a provenance tracker.

    ``state``/``from_state`` are elastic: a snapshot holds the live rows
    compacted in shard order, decoded and in global vertex order (kind
    ``"sharded"``, the reference's format), so it restores onto any
    layout — none, 1D or 2D, equal or balanced, any codec.
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
        self.policy = policy
        self.track_remaps = False
        self._remaps: list[np.ndarray] = []
        self._counts_host = np.zeros((self.D,), np.int64)
        if policy is not None:
            cap = policy.row_cap(self._row_bytes())
            if cap // self.D < 1:
                raise ValueError(
                    f"policy row cap {cap} is below one row per shard "
                    f"(D={self.D})")
            self.cap_local = min(self.cap_local, cap // self.D)
        self._live_host = np.ones((self.D * self.cap_local,), bool)
        self._tiles = [[self._new_tile(t, v, self.cap_local)
                        for v in range(self.Dv)] for t in range(self.D)]
        self._sizes = [torch.zeros(self.cap_local, dtype=torch.int32,
                                   device=self._home(t))
                       for t in range(self.D)]
        self._live = [torch.ones(self.cap_local, dtype=torch.bool,
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
        """Per-shard filled row counts ``(D,)`` (a host copy)."""
        return self._counts_host.copy()

    def _filled_host(self) -> np.ndarray:
        """Host ``(capacity,) bool`` per-shard fill-prefix mask."""
        iota = np.arange(self.cap_local)
        return (iota[None, :] < self._counts_host[:, None]).reshape(-1)

    @property
    def dead(self) -> int:
        """Filled rows whose live bit is cleared (stale or evicted)."""
        return int((self._filled_host() & ~self._live_host).sum())

    @property
    def live_count(self) -> int:
        """Filled rows that are still live (the streaming theta)."""
        return self.count - self.dead

    def _row_bytes(self) -> int:
        """At-rest bytes a global row, what a byte cap meters: ``n`` for
        bitmap tiles (the reference's accounting), otherwise the ``Dv``
        tiles' codec width times its element size."""
        if self.codec.kind == "bitmap":
            return self.n
        item = torch.empty((), dtype=self.codec.dtype).element_size()
        return self.Dv * self.codec.width * item

    @property
    def row_cap(self) -> int | None:
        """The policy's row capacity floored to a multiple of ``D`` (each
        shard holds ``row_cap // D`` rows), or None."""
        if self.policy is None:
            return None
        return (self.policy.row_cap(self._row_bytes()) // self.D) * self.D

    def live_mask(self) -> torch.Tensor:
        """``(capacity,) bool`` live bits in global slot order, on the
        first tile's device (True for unfilled slots too)."""
        return mesh_ops.all_gather(self._live, self.device).reshape(-1)

    def state_slots(self) -> np.ndarray:
        """The filled live slots: ``state()`` holds the live rows of every
        shard compacted in shard order."""
        return self._filled_host() & self._live_host

    def drain_remaps(self) -> list[np.ndarray]:
        """Pop the slot remaps recorded since the last drain (recorded
        only while ``track_remaps`` is set): compactions and per-shard
        growth alike, old global slot -> new, -1 for a reclaimed slot,
        to apply in order."""
        out, self._remaps = self._remaps, []
        return out

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
        theta shard's rows are born on the shard's device; on a 2D mesh
        it also names the tiles and the vertex blocks."""
        return BatchPlacement(
            tuple(self._home(t) for t in range(self.D)),
            tiles=(tuple(tuple(row) for row in self.devices)
                   if self.Dv > 1 else None),
            partition=self.partition if self.Dv > 1 else None)

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

    def _resize_rows(self, new_cap: int) -> None:
        """Give every shard ``new_cap`` local rows (growth, or a cut once
        wider tokens lowered the cap; the rows kept stay in place).  The
        shard blocks move: global slot ``t * cap_local + i`` becomes
        ``t * new_cap + i``, recorded for provenance trackers."""
        old = self.cap_local
        keep = min(old, new_cap)
        for t in range(self.D):
            for v in range(self.Dv):
                tile = self._new_tile(t, v, new_cap)
                tile[:keep] = self._tiles[t][v][:keep]
                self._tiles[t][v] = tile
            self._sizes[t] = self._resized(self._sizes[t], new_cap, 0)
            self._live[t] = self._resized(self._live[t], new_cap, True)
            for v in range(self.Dv if self._tile_sizes else 0):
                self._tile_sizes[t][v] = self._resized(
                    self._tile_sizes[t][v], new_cap, 0)
        live_host = np.ones((self.D * new_cap,), bool)
        remap = np.full((self.D * old,), -1, np.int64)
        for t in range(self.D):
            remap[t * old:t * old + keep] = t * new_cap + np.arange(keep)
            live_host[t * new_cap:t * new_cap + keep] = \
                self._live_host[t * old:t * old + keep]
        self._live_host = live_host
        if self.track_remaps:
            self._remaps.append(remap)
        self.cap_local = new_cap
        self._idx_cache = None
        self.version += 1

    @staticmethod
    def _resized(vec, rows: int, fill):
        out = torch.full((rows,), fill, dtype=vec.dtype, device=vec.device)
        k = min(rows, vec.shape[0])
        out[:k] = vec[:k]
        return out

    def _grow_rows(self, incoming: int):
        need = int(self._counts_host.max(initial=0)) + int(incoming)
        new_cap = next_pow2(need, self.cap_local)
        cap = self.row_cap
        if cap is not None:
            new_cap = min(new_cap, max(cap // self.D, self.cap_local))
        if new_cap != self.cap_local:
            self._resize_rows(new_cap)

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

    def _set_codec(self, codec) -> None:
        """Morph every tile to ``codec`` in place, tile by tile (decoded
        and re-encoded a block of rows at a time: nothing crosses
        tiles); counters and sizes stay."""
        from repro_torch.core.pack.stores import _recode
        if codec == self.codec:
            return
        old_codec = self.codec
        old = [[self.tile(t, v) for v in range(self.Dv)]
               for t in range(self.D)]
        self.codec = codec
        for t in range(self.D):
            for v in range(self.Dv):
                self._tiles[t][v] = self._new_tile(t, v, self.cap_local)
                _recode(old[t][v], self.tile(t, v), old_codec, codec)
        self._idx_cache = None
        self.version += 1

    def _widen_tokens(self, blocks) -> None:
        """Grow the token tiles' ``s_pad`` (a power of two) to hold the
        most tokens any row of ``blocks`` needs in any vertex tile; the
        wider tiles keep every row (new columns are sentinel)."""
        from repro_torch.core.pack.codec import (
            MIN_TOKEN_PAD, TokenCodec, tokens_needed)
        need = 0
        for t, block in enumerate(blocks):
            t = min(t, self.D - 1)
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

    def _compress_step(self) -> bool:
        """Morph the tiles one step down the policy's ladder (packed ->
        compressed: the token width covers every resident row of every
        tile); True when a step was taken."""
        from repro_torch.core.pack.codec import MIN_TOKEN_PAD, TokenCodec
        from repro_torch.core.pack.stores import _max_tokens
        ladder = self.policy.ladder if self.policy is not None else ()
        nxt = _ladder_next(self.codec.kind, ladder)
        if nxt is None:
            return False
        if nxt == "compressed":
            need = max(_max_tokens(self.tile(t, v), self.codec)
                       for t in range(self.D) for v in range(self.Dv))
            new = TokenCodec(self.n_local,
                             next_pow2(max(need, 1), MIN_TOKEN_PAD))
        else:
            new = _tile_codec(nxt, self.n_local)
        self._set_codec(new)
        obs.counter("store.compress_steps").add(1)
        return True

    def _ensure_room(self, b: int) -> None:
        """Per-shard pressure before a write of ``b`` rows a shard:
        compact away dead rows first, then climb the policy's ladder
        (each step shrinks a row's bytes and so raises a byte cap's row
        cap), and only then evict each over-full shard's oldest live
        rows.  A shard holds at most ``row_cap // D`` rows; ``b = 0``
        brings tiles whose rows grew wider back under the cap, which
        also cuts ``cap_local`` to it (the reference keeps the larger
        tiles, past its byte cap)."""
        cap = self.row_cap
        if cap is None:
            return
        local_cap = cap // self.D

        def over() -> bool:
            return int(self._counts_host.max(initial=0)) + b > local_cap
        if over() and self.dead:
            self.compact()
        while over() and self._compress_step():
            cap = self.row_cap
            local_cap = cap // self.D
        if b > local_cap:
            raise ValueError(
                f"batch of {b} rows per shard exceeds the per-shard "
                f"policy cap of {local_cap} (row cap {cap} over "
                f"{self.D} shards)")
        if over():
            self.compact()
            excess = self._counts_host + b - local_cap
            if (excess > 0).any():
                mask = np.zeros((self.capacity,), bool)
                for t in range(self.D):
                    if excess[t] > 0:
                        lo = t * self.cap_local
                        mask[lo:lo + int(excess[t])] = True
                evicted = self.kill_rows(mask)
                obs.counter("store.rows_evicted").add(evicted)
                self.compact()
        if self.cap_local > local_cap:
            self._resize_rows(local_cap)

    def _encode_tile(self, t: int, v: int, block, out, sizes) -> None:
        """Encode tile ``(t, v)``'s columns of a row block into ``out``
        (its ``k`` rows of the tile's at-rest form), add the block's
        column sums to the tile's counter partial and write its row sums
        into ``sizes``: one ``arena_commit`` launch on bitmap and packed
        tiles, PyTorch on token ones."""
        kind = self.codec.kind
        counter = self._counter[t][v]
        if kind in kops.COMMIT_KINDS:
            cols = self._tile_cols(block, t, v)
            w = cols.shape[1]
            kops.arena_commit(kops.commit_rows(cols), out[:, :self._width(w)],
                              counter[:w], kind=kind, sizes=sizes)
        else:
            bits = self._tile_bits(block, t, v)
            out[:, :self.codec.width] = self.codec.encode(bits)
            counter += bits.sum(dim=0, dtype=torch.int32)
            sizes.copy_(bits.sum(dim=1, dtype=torch.int32))

    def _width(self, w: int) -> int:
        """Elements a row of ``w`` live columns fills in a commit tile."""
        return w if self.codec.kind == "bitmap" else -(-w // 8)

    def _write_block(self, t: int, block, at) -> None:
        """Write theta shard ``t``'s row block into its tiles, with the
        rows' sizes and live bits: at ``at``, a slice of local rows
        (appended: encoded in place) or their indices (a repair: encoded
        into a staging block, then scattered)."""
        in_place = isinstance(at, slice)
        k = int(block.shape[0])
        parts = []
        for v in range(self.Dv):
            dev = self.devices[t][v]
            if in_place:
                out = self._tiles[t][v][at]
                sizes = (self._sizes[t][at] if self.Dv == 1
                         else self._tile_sizes[t][v][at])
            else:
                # zeros: a row's pad columns and bytes stay zero
                out = torch.zeros((k, self.row_stride),
                                  dtype=self.codec.dtype, device=dev)
                sizes = torch.empty(k, dtype=torch.int32, device=dev)
            self._encode_tile(t, v, block, out, sizes)
            if not in_place:
                self._tiles[t][v][at.to(dev)] = out
                if self.Dv > 1:
                    self._tile_sizes[t][v][at.to(dev)] = sizes
            parts.append(sizes)
        home = at if in_place else at.to(self._home(t))
        if self.Dv > 1:
            self._sizes[t][home] = mesh_ops.psum(parts, self._home(t))
        elif not in_place:
            self._sizes[t][home] = parts[0]
        self._live[t][home] = True

    def add_batch(self, visited, counter=None) -> np.ndarray:
        """Append ``visited (B, n)`` 0/1 rows (or a placed batch: one row
        block per theta shard), block-split across the tiles.  ``counter``
        is not needed: each tile counts its own block.  Returns the
        global slot of each batch row.  Under a `StorePressurePolicy`
        the write may first compact, morph and evict per shard."""
        del counter
        with obs.span("store.write", tier="store", kind="sharded"):
            blocks = self._row_blocks(visited)
            B = sum(int(b.shape[0]) for b in blocks)
            if B == 0:
                return np.zeros((0,), np.int64)
            b = -(-B // self.D)
            if self.codec.kind == "compressed":
                self._widen_tokens(blocks)
            kind = self.codec.kind
            self._ensure_room(b)
            if self.codec.kind == "compressed" and kind != "compressed":
                # the ladder sized its tokens for the resident rows: size
                # them for this batch too, and fit the cap again
                self._widen_tokens(blocks)
                self._ensure_room(b)
            self._grow_rows(b)
            slots = np.empty((B,), np.int64)
            for t, block in enumerate(blocks):
                k = int(block.shape[0])
                if k == 0:
                    continue
                c = int(self._counts_host[t])
                slots[t * b:t * b + k] = t * self.cap_local + c + np.arange(k)
                self._write_block(t, block.to(self._home(t)),
                                  slice(c, c + k))
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

    def _tile_contrib(self, t: int, v: int, mask) -> torch.Tensor:
        """Tile ``(t, v)``'s counter partial over the masked local rows,
        from the tile codec's counter kernel."""
        tile, kind = self.tile(t, v), self.codec.kind
        if kind == "bitmap":
            return kops.coverage_matvec(mask, tile).to(torch.int32)
        if kind == "packed":
            return kops.packed_count(tile, mask, n=self.n_local)
        return kops.token_count(tile, mask, n=self.n_local)

    def kill_rows(self, dead) -> int:
        """Mark rows dead shard by shard: each tile subtracts its dead
        rows' contribution from its own counter partial (nothing crosses
        tiles).  ``dead`` is a global ``(capacity,) bool`` mask (host or
        device); bits outside the filled, live rows are ignored.  Returns
        the number of newly dead rows."""
        dead = (dead.cpu().numpy() if isinstance(dead, torch.Tensor)
                else np.asarray(dead))
        dead = dead.astype(bool) & self._filled_host() & self._live_host
        k = int(dead.sum())
        if k == 0:
            return 0
        cap = self.cap_local
        for t in range(self.D):
            dt = dead[t * cap:(t + 1) * cap]
            if not dt.any():
                continue
            mask = torch.from_numpy(dt).to(self._home(t))
            for v in range(self.Dv):
                m = mask.to(self.devices[t][v])
                self._counter[t][v] -= self._tile_contrib(t, v, m)
                if self._tile_sizes is not None:
                    self._tile_sizes[t][v].masked_fill_(m, 0)
            self._sizes[t].masked_fill_(mask, 0)
            self._live[t] &= ~mask
        self._live_host &= ~dead
        self.version += 1
        obs.counter("store.rows_killed").add(k)
        return k

    def replace_rows(self, idx, rows) -> None:
        """Write fresh ``rows (K, n)`` 0/1 into the dead slots ``idx (K,)``
        and revive them (the streaming refresh write): each tile writes
        its own column slice of the targets in its theta block.  Targets
        must be filled, dead slots; entries of -1 are padding, neither
        stored nor counted.  Token tiles widen first; under a policy the
        store then fits its cap again (a widening lowers it)."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        real = idx >= 0
        k = int(real.sum())
        if k == 0:
            return
        tgt = idx[real]
        if ((tgt >= self.capacity).any() or not self._filled_host()[tgt].all()
                or self._live_host[tgt].any()):
            raise ValueError("replace_rows targets must be filled, dead "
                             "slots (kill_rows them first)")
        with obs.span("store.write", tier="store", kind="sharded-replace"):
            rows = torch.as_tensor(rows)
            if k != rows.shape[0]:
                rows = rows.index_select(0, torch.as_tensor(
                    np.flatnonzero(real), device=rows.device))
            if self.codec.kind == "compressed":
                self._widen_tokens([rows])
            cap = self.cap_local
            for t in range(self.D):
                sel = np.flatnonzero(tgt // cap == t)
                if not sel.size:
                    continue
                home = self._home(t)
                block = rows.index_select(0, torch.as_tensor(
                    sel, device=rows.device)).to(home)
                self._write_block(t, block, torch.as_tensor(
                    tgt[sel] - t * cap, device=home))
            self._live_host[tgt] = True
            self.version += 1
        obs.counter("store.rows_replaced").add(k)
        self._ensure_room(0)

    def compact(self) -> np.ndarray | None:
        """Move each shard's live rows to the head of its block in place
        (their order kept: the oldest first, the FIFO order eviction
        relies on), reclaiming dead slots shard by shard.  Returns the
        global old -> new slot remap (-1 for a reclaimed slot), or None
        when nothing was dead."""
        if self.dead == 0:
            return None
        keep = self._filled_host() & self._live_host
        cap = self.cap_local
        remap = np.full((self.capacity,), -1, np.int64)
        for t in range(self.D):
            kept = np.flatnonzero(keep[t * cap:(t + 1) * cap])
            remap[t * cap + kept] = t * cap + np.arange(kept.size)
            if kept.size != self._counts_host[t]:
                for v in range(self.Dv):
                    _compact_rows(self._tiles[t][v], kept, self.codec.fill)
                    if self._tile_sizes is not None:
                        self._tile_sizes[t][v] = _compact_vec(
                            self._tile_sizes[t][v], kept)
                self._sizes[t] = _compact_vec(self._sizes[t], kept)
            self._counts_host[t] = kept.size
            self._live[t] = torch.ones(cap, dtype=torch.bool,
                                       device=self._home(t))
        self._live_host = np.ones((self.capacity,), bool)
        self.version += 1
        obs.counter("store.compactions").add(1)
        if self.track_remaps:
            self._remaps.append(remap)
        return remap

    # ---------------------------------------------------------- reading ----

    def valid_mask(self) -> tuple:
        """One ``(cap_local,) bool`` mask of the filled, live rows per
        theta shard, on the shard's device."""
        return tuple(
            (torch.arange(self.cap_local, device=self._home(t))
             < int(self._counts_host[t])) & self._live[t]
            for t in range(self.D))

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

    def rows_touching(self, verts) -> torch.Tensor:
        """``rows_touching_cols`` of every vertex in ``verts``."""
        return self.rows_touching_cols(verts, np.ones(len(verts), bool))

    def coverage_stats(self) -> tuple[float, int]:
        """(avg fractional set coverage, max set size) over live sets
        (killed rows have their sizes zeroed)."""
        return _coverage_stats(self.sizes, self.live_count, self.n)

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
        live rows of every shard compacted in shard order (dead rows
        dropped), decoded per tile and put back in global vertex order,
        so any layout restores it; ``rep`` names the tile codec."""
        rows, sizes = [], []
        for t in range(self.D):
            c = int(self._counts_host[t])
            live = self._live_host[t * self.cap_local:t * self.cap_local + c]
            if not live.any():
                continue
            rows.append(np.concatenate(
                [self.codec.decode_np(self.tile(t, v)[:c].cpu().numpy())
                 [:, :self.col_width[v]] for v in range(self.Dv)],
                axis=1)[live])
            sizes.append(self._sizes[t][:c].cpu().numpy()[live])
        return {
            "kind": np.asarray("sharded"),
            "rep": np.asarray(self.codec.kind),
            "n": np.int64(self.n),
            "count": np.int64(self.live_count),
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
