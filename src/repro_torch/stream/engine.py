"""StreamEngine — influence serving on a graph that changes underneath
(``repro.stream.engine``).

    stream = StreamEngine(graph, IMMConfig(...), policy=...)   # on cuda
    stream.extend(4096)              # sample the resident store
    stream.apply_delta(delta)        # edges change; stale rows die now
    stream.select(k)                 # serves at once (live rows only)
    stream.refresh(budget=1024)      # repair stale rows incrementally
    stream.refresh()                 # ... until stream.stale == 0

  * **apply_delta** applies a `GraphDelta`, rebinds the sampler and
    kills exactly the resident rows whose traversal touched a mutated
    edge's destination (`repro_torch.stream.invalidate`).  The store's
    version bump keys the engine's select memo, so no answer mixes pre-
    and post-delta rows.  Each call opens an **epoch**.
  * **refresh(budget)** repairs in row-budgeted slices: stale rows are
    re-sampled with their batch's key on the current graph (only the
    stale positions of the batch) and written back in place
    (``replace_rows``; each repair is padded to a power of two with -1
    targets, which the store drops); rows lost to eviction are topped
    up with fresh batches from the engine's key stream.
  * **Equivalence**: with an unbounded store and a delta-stable sampler,
    refreshing until ``stale == 0`` leaves exactly the rows a fresh
    `InfluenceEngine` samples on the post-delta graph with the same seed
    and theta, so ``select(k)`` matches it seed for seed.
  * **Bounded memory**: with a `StorePressurePolicy` the arena never
    outgrows its cap; dead rows go first, then the ladder compresses,
    then the oldest live rows are evicted.

The input graph is canonicalized once (`repro_torch.stream.delta.
canonicalize`) and the sampler upgraded to its delta-stable form
(`stable_variant`).  ``snapshot``/``restore`` keep the batch keys and
each row's (batch, position) provenance in the reference's file format.
The stream runs on ``cuda`` unless ``device="cpu"`` is given.

On a mesh (``mesh``, ``theta_axes``, ``vertex_axis``) the store is a
`ShardedStore` (``cfg.store`` auto, sharded, packed or compressed tiles)
whose kills, repairs, compactions and pressure run tile by tile; a
balanced vertex partition is resolved from the *initial* graph and kept
across deltas.  The seed stream is layout-independent, so a meshed
stream refreshes to the same rows as a single-device one, and its
snapshots restore across layouts both ways (through the restored
store's ``_restore_slots``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import store as ckpt
from repro_torch.core.engine import IMMConfig, InfluenceEngine, Selection
from repro_torch.core.sampler import default_sampler_name, stable_variant
from repro_torch.core.store import StorePressurePolicy, make_store, next_pow2
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph, edge_arrays
from repro_torch.graphs.partition import resolve_partition
from repro_torch.stream.delta import GraphDelta, canonicalize
from repro_torch.stream.invalidate import invalidate


def _graph_fingerprint(graph: Graph) -> str:
    """Content hash of a graph's edges and weights (the reference's, so
    a snapshot matches its graph in either package)."""
    src, dst, prob, w = edge_arrays(graph)
    h = hashlib.sha256()
    for a in (src, dst, prob, np.asarray(w, np.float64)):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class StreamSelection(Selection):
    """A `Selection` tagged with the epoch it answered in and the
    staleness backlog then (``stale == 0``: indistinguishable from a
    fresh engine on the current graph)."""
    epoch: int = -1
    stale: int = 0


class StreamEngine:
    """Dynamic-graph influence serving over a resident, repairable store
    (see the module docstring).  ``policy`` is an optional
    `StorePressurePolicy`; the wrapped engine is ``.engine``."""

    def __init__(self, graph: Graph, cfg: IMMConfig = None, *, mesh=None,
                 theta_axes=("data",), vertex_axis=None,
                 policy: StorePressurePolicy | None = None, device=None):
        cfg = cfg if cfg is not None else IMMConfig()
        name = stable_variant(cfg.sampler
                              or default_sampler_name(graph, cfg))
        cfg = dataclasses.replace(cfg, sampler=name)
        graph = canonicalize(graph)
        if mesh is not None:
            if cfg.store not in ("auto", "sharded", "packed", "compressed"):
                raise ValueError(
                    "streaming on a mesh requires a sharded dense-at-rest "
                    "store: cfg.store='auto' (sharded bitmap), 'packed', "
                    "or 'compressed'")
            part = None
            if vertex_axis is not None:
                part = resolve_partition(
                    getattr(cfg, "partition", "equal"), graph.n,
                    int(mesh.shape[vertex_axis]),
                    dst=graph.edge_dst.cpu().numpy())
            codec = ("bitmap" if cfg.store in ("auto", "sharded")
                     else cfg.store)
            store = make_store("sharded", graph.n, mesh=mesh,
                               theta_axes=theta_axes,
                               vertex_axis=vertex_axis, policy=policy,
                               partition=part, codec=codec)
        else:
            device = resolve_device(device)
            kind = "bitmap" if cfg.store in ("auto", "sharded") else cfg.store
            store = make_store(kind, graph.n, policy=policy, device=device)
        store.track_remaps = True
        self.engine = InfluenceEngine(graph, cfg, store=store, device=device)
        self.policy = policy
        self.epoch = 0
        self.deltas_applied = 0
        self.target_theta = 0
        self.refreshes = 0
        self.rows_repaired = 0
        self.last_repair = 0
        self._batch_keys: list[np.ndarray] = []
        # which (batch id, in-batch position) produced the row in each
        # arena slot (-1: unknown or empty)
        self._slot_batch = np.full(store.capacity, -1, np.int64)
        self._slot_pos = np.full(store.capacity, -1, np.int64)

    # -------------------------------------------------------- bookkeeping

    @property
    def graph(self) -> Graph:
        return self.engine.graph

    @property
    def cfg(self) -> IMMConfig:
        return self.engine.cfg

    @property
    def store(self):
        return self.engine.store

    @property
    def theta(self) -> int:
        """Live resident RRR sets (the serving theta)."""
        return self.store.live_count

    @property
    def _effective_target(self) -> int:
        cap = self.store.row_cap
        return (self.target_theta if cap is None
                else min(self.target_theta, cap))

    @property
    def stale(self) -> int:
        """Rows `refresh` still owes: dead rows plus any eviction deficit
        below the (cap-clamped) target theta."""
        return max(0, self._effective_target - self.store.live_count)

    @property
    def consistent(self) -> bool:
        """True when serving state equals a fresh engine on the current
        graph."""
        return self.stale == 0

    @property
    def backlog(self) -> int:
        return self.stale

    def _sync_layout(self) -> bool:
        """Follow the store's slot moves (compactions, growth) through
        the provenance arrays; True when a compaction moved rows."""
        cap = self.store.capacity
        remaps = self.store.drain_remaps()
        for remap in remaps:
            nb = np.full(cap, -1, np.int64)
            npos = np.full(cap, -1, np.int64)
            old = min(remap.shape[0], self._slot_batch.shape[0])
            r = remap[:old]
            kept = r >= 0
            nb[r[kept]] = self._slot_batch[:old][kept]
            npos[r[kept]] = self._slot_pos[:old][kept]
            self._slot_batch, self._slot_pos = nb, npos
        if self._slot_batch.shape[0] > cap:     # the arena shrank
            self._slot_batch = self._slot_batch[:cap]
            self._slot_pos = self._slot_pos[:cap]
        if self._slot_batch.shape[0] < cap:
            pad = cap - self._slot_batch.shape[0]
            self._slot_batch = np.concatenate(
                [self._slot_batch, np.full(pad, -1, np.int64)])
            self._slot_pos = np.concatenate(
                [self._slot_pos, np.full(pad, -1, np.int64)])
        return bool(remaps)

    def _dead_by_batch(self) -> tuple[dict[int, list[int]], list[int]]:
        """The dead arena slots grouped by the batch that produced them,
        and those of unknown provenance."""
        by_bid: dict[int, list[int]] = {}
        for s in np.flatnonzero(~self.store.live_mask().cpu().numpy()):
            by_bid.setdefault(int(self._slot_batch[s]), []).append(int(s))
        return by_bid, by_bid.pop(-1, [])

    def _record(self, slots: np.ndarray, bid: int):
        self._slot_batch[slots] = bid
        self._slot_pos[slots] = np.arange(slots.shape[0])

    def _add_recorded_batch(self) -> int:
        """Draw one batch from the engine's key stream, store it and
        record its provenance; returns the rows written."""
        key, visited, counter = self.engine.sample_batch()
        bid = len(self._batch_keys)
        self._batch_keys.append(key)
        slots = self.store.add_batch(visited, counter)
        self._sync_layout()
        self._record(slots, bid)
        return slots.shape[0]

    # ----------------------------------------------------------- sampling

    def _clamped(self, theta: int) -> int:
        cap = self.store.row_cap
        return int(theta) if cap is None else min(int(theta), cap)

    def extend(self, theta: int) -> int:
        """Sample until the store holds >= ``theta`` live rows (clamped
        to the policy's row cap, read again after every batch: a ladder
        step or a token widening moves it), recording every batch's key
        for same-key repair.  Returns the live count."""
        while self.store.live_count < self._clamped(theta):
            self._add_recorded_batch()
        self.target_theta = max(self.target_theta, self._clamped(theta))
        return self.store.live_count

    # ------------------------------------------------------------- deltas

    def apply_delta(self, delta: GraphDelta) -> int:
        """Apply a `GraphDelta`: mutate the graph, rebind the sampler and
        kill the resident rows that touched a mutated edge's
        destination.  Opens a new epoch; returns the rows gone stale."""
        with obs.span("delta", tier="stream", epoch=self.epoch + 1):
            new_graph = delta.apply(self.graph)
            stale = invalidate(self.store, delta.touched_vertices())
            self.engine.rebind_graph(new_graph)
        self.epoch += 1
        self.deltas_applied += 1
        obs.counter("stream.deltas").add(1)
        obs.counter("stream.rows_invalidated").add(stale)
        obs.gauge("stream.backlog").set(self.stale)
        return stale

    def refresh(self, budget: int | None = None) -> int:
        """Repair up to ``budget`` rows (None: all) and return the
        remaining backlog.  In order (batch-granular, so a budget is
        approximate): stale rows with a known batch key are re-sampled
        with it and replaced in place; stale slots of unknown provenance
        are compacted away; a live deficit below the target theta is
        topped up with fresh batches."""
        if budget is not None and int(budget) < 1:
            raise ValueError(
                f"refresh budget must be >= 1 row (got {budget}); a "
                f"zero budget can never drain the backlog")
        store = self.store
        if store.dead == 0 and self.stale == 0:
            return 0
        with obs.span("refresh", tier="stream",
                      budget=-1 if budget is None else int(budget)):
            self._sync_layout()
            left = math.inf if budget is None else int(budget)
            repaired = 0
            by_bid, orphans = self._dead_by_batch()
            row_repair = self.engine.supports_row_resample
            while left > 0 and by_bid:
                bid = min(by_bid)
                slots = np.asarray(by_bid.pop(bid), np.int64)
                # the reference pads each repair to a power of two (its
                # kernels retrace per width); the -1 targets are dropped
                k = slots.shape[0]
                width = next_pow2(k, 1)
                idx = np.full(width, -1, np.int64)
                idx[:k] = slots
                pos = np.zeros(width, np.int64)
                pos[:k] = self._slot_pos[slots]
                if row_repair:
                    rows, _ = self.engine.resample(self._batch_keys[bid],
                                                   positions=pos)
                else:
                    visited, _ = self.engine.resample(self._batch_keys[bid])
                    rows = visited.index_select(0, torch.as_tensor(
                        pos, device=visited.device))
                store.replace_rows(idx, rows)
                left -= k
                repaired += k
                if self._sync_layout():
                    # the write widened the token rows past the byte cap
                    # and the store compacted (and evicted) to fit it:
                    # the dead rows left have moved or are gone
                    by_bid, orphans = self._dead_by_batch()
            if orphans and left > 0:
                store.compact()
                self._sync_layout()
            while self.store.live_count < self._effective_target and left > 0:
                got = self._add_recorded_batch()
                left -= got
                repaired += got
        self.refreshes += 1
        self.rows_repaired += repaired
        self.last_repair = repaired
        obs.counter("stream.refreshes").add(1)
        obs.counter("stream.rows_repaired").add(repaired)
        obs.gauge("stream.backlog").set(self.stale)
        return self.stale

    # ------------------------------------------------------- checkpointing

    def snapshot(self, directory: str, *, tag: str = "stream") -> str:
        """Persist the engine's state plus the repair provenance (every
        batch key, the (batch, position) of every arena slot, dead rows
        included) in one atomic file, the reference's format."""
        self._sync_layout()
        # the provenance follows the rows the store's state holds (a
        # sharded one's live rows compacted in shard order)
        keep = self.store.state_slots()
        slot_batch = self._slot_batch[keep]
        slot_pos = self._slot_pos[keep]
        keys = (np.stack([np.asarray(k) for k in self._batch_keys])
                if self._batch_keys else np.zeros((0, 2), np.uint32))
        tree = {
            "engine": self.engine.snapshot_tree(),
            "stream": {
                "batch_keys": keys,
                "slot_batch": np.asarray(slot_batch, np.int64),
                "slot_pos": np.asarray(slot_pos, np.int64),
                "batch": np.int64(self.cfg.batch),
                "graph_sha": np.asarray(_graph_fingerprint(self.graph)),
                "target_theta": np.int64(self.target_theta),
                "epoch": np.int64(self.epoch),
                "deltas_applied": np.int64(self.deltas_applied),
            },
        }
        return ckpt.save_named(directory, tag, tree)

    def restore(self, directory: str, *, tag: str = "stream") -> bool:
        """Resume from `snapshot` (a file of either package); False when
        none exists.  The sampler, batch width and graph must be the
        snapshot's, else same-key repair would be wrong and this raises.
        A store restored by re-adding rows follows them through
        ``_restore_slots``."""
        tree = ckpt.load_named(directory, tag)
        if tree is None:
            return False
        saved_sampler = str(np.asarray(tree["engine"]["meta"]["sampler"]))
        if saved_sampler != self.engine.sampler_name:
            raise ValueError(
                f"snapshot was sampled with {saved_sampler!r}, this "
                f"stream resolves {self.engine.sampler_name!r}; same-key "
                f"repair needs the identical sampler composition")
        saved_batch = int(tree["stream"]["batch"])
        if saved_batch != self.cfg.batch:
            raise ValueError(
                f"snapshot was sampled with batch={saved_batch}, this "
                f"stream has batch={self.cfg.batch}; same-key repair "
                f"needs the identical batch width")
        if str(np.asarray(tree["stream"]["graph_sha"])) != \
                _graph_fingerprint(self.graph):
            raise ValueError(
                "snapshot was taken against a different graph (edge "
                "set/weights differ); construct the stream with the "
                "snapshot's graph, then apply further deltas")
        self.engine.restore_tree(tree["engine"])
        store = self.store
        store.track_remaps = True
        store.policy = self.policy      # a restore drops it; re-arm the cap
        st = tree["stream"]
        keys = np.asarray(st["batch_keys"])
        self._batch_keys = [keys[i] for i in range(keys.shape[0])]
        self.target_theta = int(st["target_theta"])
        self.epoch = int(st["epoch"])
        self.deltas_applied = int(st["deltas_applied"])
        prov_b = np.asarray(st["slot_batch"], np.int64)
        prov_p = np.asarray(st["slot_pos"], np.int64)
        self._slot_batch = np.full(store.capacity, -1, np.int64)
        self._slot_pos = np.full(store.capacity, -1, np.int64)
        slots = getattr(store, "_restore_slots", None)
        if slots is None:
            # same-layout restore: snapshot rows are the arena slots
            k = min(store.capacity, prov_b.shape[0])
            self._slot_batch[:k] = prov_b[:k]
            self._slot_pos[:k] = prov_p[:k]
            return True
        snap_store = tree["engine"]["store"]
        if str(np.asarray(snap_store["kind"])) != "sharded":
            # a full-arena snapshot re-added row by row keeps its live
            # rows only: filter the provenance alike
            count = int(snap_store["count"])
            prov_b, prov_p = prov_b[:count], prov_p[:count]
            if "live" in snap_store:
                live = np.asarray(snap_store["live"])[:count].astype(bool)
                prov_b, prov_p = prov_b[live], prov_p[live]
        self._slot_batch[slots] = prov_b[:slots.shape[0]]
        self._slot_pos[slots] = prov_p[:slots.shape[0]]
        return True

    # ------------------------------------------------------------ queries

    def select(self, k: int = None, *, method: str = None) -> StreamSelection:
        """Greedy top-k over the live rows, tagged with the epoch and
        backlog it was answered under (memoized by the engine, keyed by
        the store version that every delta bumps)."""
        sel = self.engine.select(k, method=method)
        return StreamSelection(
            seeds=sel.seeds, covered_frac=sel.covered_frac,
            influence=sel.influence, gains=sel.gains,
            representation=sel.representation, theta=self.theta,
            epoch=self.epoch, stale=self.stale)

    def influences(self, seed_sets) -> np.ndarray:
        """Batched sigma(S) against the live rows of the current epoch."""
        return self.engine.influences(seed_sets)

    def influence(self, seed_set) -> float:
        """sigma(S) against the live rows of the current epoch."""
        return self.engine.influence(seed_set)
