"""InfluenceEngine — resumable, multi-query IMM on one device
(``repro.core.engine``).

    engine = InfluenceEngine(graph, IMMConfig(model="IC"))   # on cuda
    result = engine.run()                 # Algorithm 1
    top10  = engine.select(10)            # more queries, no re-sampling
    sigma  = engine.influence([5, 17])    # sigma(S) for any seed set
    engine.snapshot(ckpt_dir)             # resumable (checkpoint.store)

Sampling goes through the sampler registry (`repro_torch.core.sampler`),
batches land in a preallocated store — a `BitmapStore`, with
``cfg.store`` ``"packed"``/``"compressed"`` an IMPack arena
(`repro_torch.core.pack`), with ``"indices"`` an `IndexStore` of C4
index lists — through the fused sample -> write -> count extender where
the at-rest form has one, and selection goes through the strategy
registry (`repro_torch.core.selection`), memoized per (store version,
k, method).  An `IndexStore` takes the sparse sampler's batches as
index lists straight away (``emit_l``): the emission width doubles and
the batch is re-emitted with the same key when a row comes back full.
The C4 chooser (``adaptive_representation``, n >= ``sparse_rep_min_n``)
sends sparse sets of any store to index-list selection through the
store's ``index_view``.  For a fixed ``cfg.seed`` every seed, theta,
coverage and arena byte equals the JAX package's, on every store, with
the sparse sampler; the dense and pallas samplers (the default for
n <= ``dense_sampler_max_n``) equal it up to near-tie coin flips
(`repro_torch.core.ties`), and selection on a given store is exact.
Stable samplers re-generate row subsets of a recorded batch
(`resample`).

``snapshot``/``restore`` write and read the reference's checkpoint
files (`repro_torch.checkpoint.store`), so either package resumes the
other's engine; ``replicate`` builds a read replica that shares no
tensor with the primary.

The engine runs on ``cuda`` unless ``device="cpu"`` is passed; without a
GPU and without ``device="cpu"`` it raises rather than carry on slowly
on the host.

Given a ``mesh`` (`repro_torch.mesh.Mesh`, ``theta_axes``, and a
``vertex_axis`` for a 2D mesh) the engine runs the paper's C1
partitioning end to end, as the reference's does: its arena is a
`ShardedStore` (``store="auto"``; ``"packed"``/``"compressed"`` give
tiles of that codec), the sampler samples each theta shard's rows on the
shard's device, and selection reads the tiles in place (the C4 choice
per vertex shard, through the store's tile-local ``index_view``).  A
meshed engine is seed for seed the single-device one; its snapshots
restore across layouts (none, 1D, 2D) both ways.  It writes each batch
through ``ShardedStore.add_batch`` and has no fused extender.  On a 2D
mesh the dense and pallas samplers column-block their BFS over the
vertex tiles (``cfg.overlap`` overlaps the frontier gather with the
step).  A stable sampler re-samples a row subset of a meshed batch
(`resample` with ``positions``), so a `repro_torch.stream.StreamEngine`
runs on a mesh too.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import mesh as mesh_ops
from repro_torch import obs, prng
from repro_torch.checkpoint import store as ckpt
from repro_torch.core import martingale as mg
from repro_torch.core import pack  # noqa: F401  (registers pack layouts)
from repro_torch.core.adaptive import choose_representation, l_pad_for
from repro_torch.core.fused import make_fused_extender
from repro_torch.core.sampler import (
    bind_sampler, default_sampler_name, get_sampler,
)
from repro_torch.core.selection import get_selection
from repro_torch.core.store import (
    ShardedStore, make_store, next_pow2, store_from_state,
)
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph
from repro_torch.graphs.partition import resolve_partition


_PACK_REPS = ("packed", "compressed")
# selection layout of each representation
_LAYOUTS = {"bitmap": "dense", "packed": "packed", "compressed": "compressed",
            "indices": "sparse"}


@dataclasses.dataclass
class IMMConfig:
    """The reference's configuration, field for field.  Inert here:
    ``pallas_interpret`` (no Pallas), ``fuse_counters`` (informational in
    the reference too).  ``partition`` lays out a 2D mesh's vertex axis
    (``"equal"`` or ``"balanced"``); ``overlap`` runs a column-blocked
    BFS's frontier gather on a side stream (it changes no result)."""
    k: int = 50
    eps: float = 0.5
    ell: float = 1.0
    model: str = "IC"
    backend: Optional[str] = None
    stable: bool = False
    pallas_interpret: bool = False
    batch: int = 256                  # RRR sets per sampling call
    max_theta: int = 1 << 16          # safety cap
    dense_sampler_max_n: int = 4096
    selection_method: str = "rebuild"  # "rebuild" | "decrement" |
    #                                  # "fused-rebuild" | "fused-decrement"
    adaptive_representation: bool = True  # C4
    sparse_rep_min_n: int = 65536
    fuse_counters: bool = True
    switch_ratio: int = 32
    store: str = "auto"               # "auto" | "bitmap" | "indices" |
    #                                  # "packed" | "compressed" | "sharded"
    partition: str = "equal"
    overlap: bool = True
    fused_pipeline: str = "auto"      # "auto" | "off"
    sampler: Optional[str] = None
    seed: int = 0


@dataclasses.dataclass
class IMMResult:
    seeds: np.ndarray
    influence: float          # n * covered_frac
    covered_frac: float
    theta: int
    rounds: int
    representation: str
    counter: np.ndarray       # fused global counter over all sampled sets


@dataclasses.dataclass(frozen=True)
class Selection:
    """One answered seed-selection query."""
    seeds: np.ndarray
    covered_frac: float
    influence: float
    gains: np.ndarray
    representation: str
    theta: int


class InfluenceEngine:
    """Stateful IMM engine over a persistent RRR store, on one device or
    on a mesh (``mesh``, ``theta_axes``, ``vertex_axis``; a given
    `ShardedStore` implies its mesh and axes).  On a mesh the device
    defaults to the first tile's."""

    def __init__(self, graph: Graph, cfg: IMMConfig = None, *,
                 store=None, mesh=None, theta_axes=("data",),
                 vertex_axis=None, device=None):
        if mesh is None and isinstance(store, ShardedStore):
            mesh, theta_axes = store.mesh, store.theta_axes
            vertex_axis = store.vertex_axis
        self.mesh = mesh
        self.theta_axes = ((theta_axes,) if isinstance(theta_axes, str)
                           else tuple(theta_axes))
        self.vertex_axis = vertex_axis
        if device is None and mesh is not None:
            device = mesh.tile_devices(self.theta_axes, vertex_axis)[0][0]
        self.device = resolve_device(device)
        self.graph = graph.to(self.device)
        self.cfg = cfg if cfg is not None else IMMConfig()
        self.key = prng.PRNGKey(self.cfg.seed)
        kind = self.cfg.store
        if store is not None:
            self.store = store
        elif mesh is not None and kind in ("auto", "sharded") + _PACK_REPS:
            self.store = ShardedStore(
                graph.n, mesh=mesh, theta_axes=self.theta_axes,
                vertex_axis=vertex_axis,
                codec=kind if kind in _PACK_REPS else "bitmap",
                partition=self._resolve_partition(mesh, vertex_axis))
        elif mesh is not None and kind == "indices":
            raise ValueError(
                "store='indices' cannot be combined with a mesh: "
                "IndexStore (and its snapshots) is single-device only. "
                "Use a dense at-rest representation (store='auto', "
                "'bitmap', 'packed', or 'compressed'), all of which "
                "shard across the mesh.")
        elif kind == "sharded":
            raise ValueError("store='sharded' needs a mesh")
        else:
            self.store = make_store(kind, graph.n, device=self.device)
        self.sampler_name = self.cfg.sampler or default_sampler_name(
            self.graph, self.cfg)
        self._sample = self._bind_sampler()
        self._reset_index_emission()
        self._rebind_fused()
        self._select_cache: dict = {}

    def _bind_sampler(self):
        """The bound sampler, placed as a meshed store asks (each theta
        shard's rows sampled on its device)."""
        return bind_sampler(get_sampler(self.sampler_name), self.graph,
                            self.cfg, placement=getattr(
                                self.store, "batch_placement", None))

    def _resolve_partition(self, mesh, vertex_axis):
        """The configured vertex-axis `VertexPartition` of a meshed store
        (None without a vertex axis).  ``cfg.partition="balanced"``
        derives the boundaries from the graph's dst degrees:
        deterministic per (graph, Dv), so replicas and restores rebuild
        the same layout."""
        if mesh is None or vertex_axis is None:
            return None
        return resolve_partition(
            getattr(self.cfg, "partition", "equal"), self.graph.n,
            int(mesh.shape[vertex_axis]),
            dst=self.graph.edge_dst.cpu().numpy())

    def _reset_index_emission(self) -> None:
        """The native index-emission width for the current store: zero
        (bitmap rows) unless the store is an `IndexStore` and the bound
        sampler emits index lists.  Called at construction and after
        every store swap (a restore may change the store's kind)."""
        self._emit_l = 0
        if (self.store.representation == "indices"
                and getattr(self._sample, "supports_index_emit", False)):
            self._emit_l = int(getattr(self.store, "l_pad", 4))

    def _rebind_fused(self) -> None:
        """The fused extender for the current (store, sampler) pair; None
        when disabled, under index emission, or for a store kind without
        a fused chain."""
        self._fused = None
        if getattr(self.cfg, "fused_pipeline", "auto") != "off" \
                and not self._emit_l and self.mesh is None:
            self._fused = make_fused_extender(
                self.store, self._sample, self.cfg,
                sampler_name=self.sampler_name)

    # ------------------------------------------------------------ sampling

    @property
    def theta(self) -> int:
        return self.store.count

    def extend(self, theta: int) -> int:
        """Sample batches until the store holds >= ``theta`` RRR sets.
        The key stream is ``(key, sub) = split(key)`` per batch, as in the
        reference, so a fixed seed gives a bitwise-identical stream.
        Under a `StorePressurePolicy` the target clamps to the store's
        row cap (the store evicts to make room), read again after every
        batch: a ladder step or a token widening moves it."""
        def target():
            cap = getattr(self.store, "row_cap", None)
            return theta if cap is None else min(theta, cap)

        with obs.span("extend", tier="engine", target=target()):
            while self.store.count < target():
                self.key, sub = prng.split(self.key)
                if self._emit_l:
                    with obs.span("sample", tier="engine",
                                  sampler=self.sampler_name):
                        rows_idx, counter = self._sample_index_batch(sub)
                    self.store.add_index_batch(rows_idx, counter)
                elif (self._fused is not None
                        and self._fused.extend_once(sub)):
                    pass
                else:
                    with obs.span("sample", tier="engine",
                                  sampler=self.sampler_name):
                        visited, counter, _ = self._sample(sub)
                    self.store.add_batch(visited, counter)
                obs.counter("engine.batches_sampled").add(1)
        obs.gauge("engine.theta").set(self.store.count)
        return self.store.count

    def _sample_index_batch(self, sub):
        """One batch as index lists.  A row that comes back full may have
        been cut at the emission width: double the width and re-emit with
        the same key (same coins, wider lists); the width only grows, and
        caps at n exactly."""
        n = self.graph.n
        while True:
            rows_idx, counter, _ = self._sample(sub, emit_l=self._emit_l)
            if self._emit_l >= n or not bool((rows_idx[:, -1] < n).any()):
                return rows_idx, counter
            self._emit_l = min(self._emit_l * 2, n)
            obs.counter("engine.index_reemits").add(1)

    def sample_batch(self):
        """Advance the PRNG stream by one batch without writing to the
        store: ``(batch_key, visited, counter)``.  The key chain is the
        one `extend` walks, so a caller that records ``batch_key`` (the
        streaming refresh) can `resample` the same batch later."""
        self.key, sub = prng.split(self.key)
        visited, counter, _ = self._sample(sub)
        return np.asarray(sub), visited, counter

    @property
    def supports_row_resample(self) -> bool:
        """Whether the bound sampler can re-generate an arbitrary subset
        of a batch's rows (the stable samplers' ``positions`` hook)."""
        return "positions" in inspect.signature(self._sample).parameters

    def resample(self, batch_key, positions=None):
        """Re-run the sampler for a recorded batch key: returns
        ``(visited, counter)``.  ``positions`` (requires
        `supports_row_resample`) re-generates only those rows of the
        batch, bitwise the rows of the full batch (on a mesh, sampled on
        the first shard's device).  A whole meshed batch comes back as
        one ``(B, n)`` tensor there too."""
        key = prng.as_key(batch_key)
        if positions is None:
            visited, counter, _ = self._sample(key)
        else:
            visited, counter, _ = self._sample(
                key, positions=np.asarray(positions, np.int32))
        if isinstance(visited, tuple):
            visited = torch.cat([b.to(self.device) for b in visited])
            counter = mesh_ops.psum(list(counter), self.device)
        return visited, counter

    def rebind_graph(self, graph: Graph) -> None:
        """Point the engine at a mutated graph (the streaming delta
        path): later sampling uses the new edges while the store's
        resident sets stay (`repro_torch.stream` kills the stale ones).
        The select memo is kept: the store's version, which every kill
        and replace bumps, keys it."""
        self.graph = graph.to(self.device)
        self._sample = self._bind_sampler()
        self._rebind_fused()

    # ----------------------------------------------------------- selection

    def _choose_representation(self) -> str:
        """The C4 choice: ``"indices"`` when the sets are sparse past the
        switch ratio (or the store holds index lists), else the store's
        own at-rest representation (bitmap, packed or compressed)."""
        rep = self.store.representation
        if rep == "indices":
            return rep
        cfg = self.cfg
        if (cfg.adaptive_representation
                and self.graph.n >= cfg.sparse_rep_min_n):
            avg_cov, l_max = self.store.coverage_stats()
            width = self.graph.n
            if isinstance(self.store, ShardedStore):
                # C4 per vertex shard: a shard's lists hold only its
                # n_local columns of every set
                width, l_max = (self.store.n_local,
                                self.store.max_local_size())
            if choose_representation(avg_cov, width, l_max,
                                     cfg.switch_ratio) == "indices":
                return "indices"
        return rep

    def select(self, k: int = None, *, method: str = None) -> Selection:
        """Greedy max-coverage over the current store, memoized."""
        cfg = self.cfg
        k = min(cfg.k if k is None else int(k), self.graph.n)
        if k < 1:
            raise ValueError(f"select needs k >= 1, got {k}")
        method = method or cfg.selection_method
        cache_key = (self.store.version, self.store.count, k, method)
        hit = self._select_cache.get(cache_key)
        if hit is not None:
            obs.counter("engine.select_cache_hits").add(1)
            return hit
        obs.counter("engine.select_cache_misses").add(1)
        if self.mesh is not None:
            # the tiles go to the strategy in place; a single-device
            # store's arena is scattered over the mesh by the strategy
            if self.store.representation == "indices":
                raise ValueError(
                    "sharded selection requires a dense-at-rest store "
                    "(bitmap, packed, or compressed)")
            rep = self._choose_representation()
            if rep == "indices" and isinstance(self.store, ShardedStore):
                view = self.store.index_view(
                    l_pad_for(self.store.max_local_size()))
                layout = "sharded-sparse"
            else:
                rep = self.store.representation
                view, layout = self.store.view(), "sharded"
        else:
            rep = self._choose_representation()
            layout = _LAYOUTS[rep]
            if rep == "indices" and self.store.representation != "indices":
                _, l_max = self.store.coverage_stats()
                view = self.store.index_view(l_pad_for(l_max))
            else:
                view = self.store.view()
        strategy = get_selection(method, layout)
        with obs.span("select", tier="engine", k=k, method=method,
                      layout=layout):
            seeds, frac, gains = strategy(
                view, k, mesh=self.mesh, theta_axes=self.theta_axes,
                vertex_axis=self.vertex_axis,
                partition=getattr(self.store, "partition", None),
                codec=getattr(self.store, "codec", None))
            seeds, frac, gains = (seeds.cpu().numpy(), float(frac),
                                  gains.cpu().numpy())
        sel = Selection(seeds=seeds, covered_frac=frac,
                        influence=frac * self.graph.n, gains=gains,
                        representation=rep, theta=self.store.count)
        self._select_cache[cache_key] = sel
        return sel

    # ----------------------------------------------------------- influence

    def influences(self, seed_sets: Sequence[Sequence[int]]) -> np.ndarray:
        """sigma(S) estimates for a batch of seed sets in one pass.  Sets
        pad with their own first element, the query axis to a power of
        two, as in the reference."""
        if not len(seed_sets):
            return np.zeros((0,), np.float64)
        sets = [np.asarray(s, np.int32).reshape(-1) for s in seed_sets]
        for i, s in enumerate(sets):
            if s.size == 0:
                raise ValueError(f"seed set {i} is empty")
            if (s < 0).any() or (s >= self.graph.n).any():
                raise ValueError(f"seed set {i} has out-of-range vertices")
        q = len(sets)
        l_pad = next_pow2(max(s.size for s in sets), 1)
        q_pad = next_pow2(q, 1)
        S = np.empty((q_pad, l_pad), np.int32)
        for i in range(q_pad):
            s = sets[min(i, q - 1)]
            S[i, :s.size] = s
            S[i, s.size:] = s[0]
        with obs.span("influence", tier="engine", queries=q):
            fracs = self.store.hits(S).cpu().numpy()[:q]
        return fracs.astype(np.float64) * self.graph.n

    def influence(self, seed_set: Sequence[int]) -> float:
        """sigma(S) ~= n * F_R(S) for one seed set against the store."""
        return float(self.influences([seed_set])[0])

    # ------------------------------------------------------- checkpointing

    def snapshot_tree(self) -> dict:
        """Store + PRNG key + meta as a numpy tree — the reference's
        `snapshot_tree` format, so either package restores the other's."""
        return {
            "store": self.store.state(),
            "key": np.asarray(self.key),
            "meta": {
                "n": np.int64(self.graph.n),
                "model": np.asarray(self.cfg.model),
                "sampler": np.asarray(self.sampler_name),
            },
        }

    def snapshot(self, directory: str, *, tag: str = "engine") -> str:
        """Save store + PRNG state atomically in the reference's
        checkpoint format; returns the file's path."""
        return ckpt.save_named(directory, tag, self.snapshot_tree())

    def restore_tree(self, tree: dict) -> None:
        """Adopt a `snapshot_tree` (validates n/model, rebuilds the store
        on this engine's device, resumes the PRNG stream).  A packed- or
        compressed-configured engine re-encodes whatever the snapshot
        holds; other configurations keep the snapshot's own kind, as in
        the reference, and index emission follows the restored store."""
        meta = tree["meta"]
        if int(meta["n"]) != self.graph.n:
            raise ValueError(
                f"snapshot is for n={int(meta['n'])}, graph has n={self.graph.n}")
        if str(np.asarray(meta["model"])) != self.cfg.model:
            raise ValueError(
                f"snapshot model {np.asarray(meta['model'])} != cfg.model "
                f"{self.cfg.model}")
        target = self.cfg.store if self.cfg.store in _PACK_REPS else None
        # elastic across layouts: a meshed engine re-tiles any snapshot on
        # its mesh; an engine that keeps a single-device store keeps one
        mesh = self.mesh if isinstance(self.store, ShardedStore) else None
        vx = self.vertex_axis if mesh is not None else None
        self.store = store_from_state(
            tree["store"], device=self.device, kind=target, mesh=mesh,
            theta_axes=self.theta_axes, vertex_axis=vx,
            partition=self._resolve_partition(mesh, vx))
        self.key = prng.as_key(tree["key"])
        self._reset_index_emission()
        self._rebind_fused()
        self._select_cache.clear()

    def restore(self, directory: str, *, tag: str = "engine") -> bool:
        """Resume from `snapshot`; False when no snapshot exists."""
        tree = ckpt.load_named(directory, tag)
        if tree is None:
            return False
        self.restore_tree(tree)
        return True

    def replicate(self, tree: dict = None) -> "InfluenceEngine":
        """A read replica: a new engine over the same graph, config, mesh
        and device, restored from a host copy of ``tree`` (default: this
        engine's `snapshot_tree`), so it shares no tensor with the
        primary and answers ``select``/``influence`` as the primary did
        at the snapshot."""
        if tree is None:
            tree = self.snapshot_tree()
        replica = InfluenceEngine(
            self.graph, self.cfg, mesh=self.mesh, theta_axes=self.theta_axes,
            vertex_axis=self.vertex_axis, device=self.device)
        replica.restore_tree(ckpt.clone_tree(tree))
        return replica

    # ---------------------------------------------------- Algorithm 1

    def run(self) -> IMMResult:
        """IMM Algorithm 1 (Sampling phase -> Set_Theta -> Selection)."""
        cfg, n = self.cfg, self.graph.n
        k = min(cfg.k, n)
        bounds = mg.compute_bounds(n, k, cfg.eps, cfg.ell)
        lb = 1.0
        rounds = 0

        with obs.span("run", tier="engine", n=n, k=k):
            for i in range(1, bounds.max_rounds + 1):
                rounds = i
                theta_i = min(mg.round_theta(bounds, i), cfg.max_theta)
                with obs.span("round", tier="engine", round=i,
                              theta=theta_i):
                    self.extend(theta_i)
                    sel = self.select(k)
                obs.counter("engine.rounds").add(1)
                if n * sel.covered_frac >= mg.round_target(bounds, i):
                    lb = mg.lower_bound_from_coverage(bounds, sel.covered_frac)
                    break
                if self.store.count >= cfg.max_theta:
                    lb = max(
                        mg.lower_bound_from_coverage(bounds, sel.covered_frac),
                        1.0)
                    break

            theta = min(mg.theta_from_lb(bounds, lb), cfg.max_theta)
            self.extend(theta)
            sel = self.select(k)
        return IMMResult(
            seeds=sel.seeds,
            influence=sel.influence,
            covered_frac=sel.covered_frac,
            theta=self.store.count,
            rounds=rounds,
            representation=sel.representation,
            counter=self.store.counter.cpu().numpy(),
        )
