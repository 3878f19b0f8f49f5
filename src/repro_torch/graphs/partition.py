"""Host-side vertex/edge partitioners (``repro.graphs.partition``), numpy
only, so every output equals the reference's array for array.

`VertexPartition` is the one definition of the *vertex-axis* block layout
the meshed influence pipeline shares: the `ShardedStore` tile columns,
sharded selection's local <-> global vertex id mapping and the streaming
reverse-touch queries all agree on the same contiguous blocks, so no
layer ever reindexes another's output.

Two layouts live behind the one abstraction:

* **equal** (``bounds is None``): vertex ``u`` lives in block
  ``u // block`` at local id ``u % block``.
* **balanced** (``bounds`` set): blocks are still contiguous ascending
  runs of global ids, but the boundaries are *data-dependent* — chosen by
  `balanced_vertex_partition` so per-shard dst-edge counts are near-equal
  on skewed (power-law) graphs.  Every tile is padded to the width of the
  largest block (``block = max(sizes)``); pad columns hold no vertex and
  stay all-zero everywhere.

Because both layouts keep blocks contiguous and ascending, any consumer
that resolves "first global id with the max value" per shard and then
takes the first shard with the global max gets exactly the unsharded
first-argmax answer — which is why selection stays seed-for-seed
identical when the boundaries move.

`partition_edges_by_dst` sorts edges so every shard's slab targets only
its own dst block (padding edges carry the local sentinel ``block``), and
`balance_report` gives the per-shard dst-edge imbalance of a layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class VertexPartition:
    """Contiguous block partition of ``n`` vertices over ``shards``
    vertex shards.  ``block`` is the padded tile width (the largest block
    size); ``n_pad = shards * block`` is the SPMD-padded column count
    (pad columns hold no vertex and stay all-zero everywhere).

    ``bounds`` is ``None`` for the equal-block layout (vertex ``u`` lives
    in block ``u // block``), or a tuple of ``shards + 1`` ascending
    start offsets (``bounds[0] == 0``, ``bounds[-1] == n``) for an
    edge-balanced layout with data-dependent boundaries.
    """
    n: int
    shards: int
    block: int      # padded tile width (max vertices in any shard)
    n_pad: int      # shards * block — the padded global column count
    bounds: tuple = None   # None (equal) or (shards+1,) ascending starts

    # -- layout queries ----------------------------------------------------
    @property
    def starts(self) -> np.ndarray:
        """(shards + 1,) int32 block start offsets in global-id space
        (``starts[s] .. starts[s+1]`` is shard s's vertex range)."""
        if self.bounds is None:
            return np.minimum(
                np.arange(self.shards + 1, dtype=np.int64) * self.block,
                self.n).astype(np.int32)
        return np.asarray(self.bounds, dtype=np.int32)

    @property
    def sizes(self) -> np.ndarray:
        """(shards,) int32 live vertex count per shard (≤ ``block``)."""
        return np.diff(self.starts).astype(np.int32)

    def block_of(self, u):
        if self.bounds is None:
            return u // self.block
        return np.searchsorted(self.starts, u, side="right") - 1

    def local_id(self, u):
        if self.bounds is None:
            return u - (u // self.block) * self.block
        return u - self.starts[self.block_of(u)]

    def padded_col(self, u):
        """Padded column index of vertex ``u`` in the (n_pad,) layout."""
        return self.block_of(u) * self.block + self.local_id(u)

    # -- host-side gather maps (layout <-> global order) -------------------
    def source_cols(self) -> np.ndarray:
        """(n_pad,) int32: global vertex id backing each padded column,
        or the sentinel ``n`` for pad columns (gather with a masked
        source to build the layout from a global-order array)."""
        starts, sizes = self.starts, self.sizes
        cols = np.full(self.n_pad, self.n, dtype=np.int32)
        for s in range(self.shards):
            c = int(sizes[s])
            cols[s * self.block: s * self.block + c] = np.arange(
                starts[s], starts[s] + c, dtype=np.int32)
        return cols

    def padded_cols(self) -> np.ndarray:
        """(n,) int32: padded column of each vertex (inverse of
        `source_cols` restricted to live columns; gather with it to put a
        layout array back in global vertex order)."""
        starts, sizes = self.starts, self.sizes
        out = np.empty(self.n, dtype=np.int32)
        for s in range(self.shards):
            c = int(sizes[s])
            out[starts[s]: starts[s] + c] = s * self.block + np.arange(
                c, dtype=np.int32)
        return out

    @property
    def is_equal(self) -> bool:
        return self.bounds is None


def vertex_partition(n: int, shards: int) -> VertexPartition:
    """The canonical equal-block vertex-axis layout for ``n`` vertices
    over ``shards`` shards (shards=1 degenerates to the unsharded layout:
    block == n_pad == n)."""
    shards = max(int(shards), 1)
    block = -(-int(n) // shards)
    return VertexPartition(int(n), shards, block, shards * block)


def balanced_vertex_partition(n: int, shards: int, dst=None,
                              weights=None) -> VertexPartition:
    """Edge-balanced contiguous layout: block boundaries are placed at
    the quantiles of the cumulative per-vertex weight (dst-degree + 1 by
    default), so each shard owns a near-equal share of the edges that
    `partition_edges_by_dst` / the store's column tiles will route to it.

    Blocks remain contiguous ascending global-id runs — only the
    boundaries are data-dependent — so every consumer of
    `VertexPartition` (store tiles, selection's id mapping, reverse
    touch) works unchanged.  The ``+ 1`` vertex term keeps isolated
    vertices weighted, so blocks stay non-degenerate on sparse graphs.
    """
    shards = max(int(shards), 1)
    n = int(n)
    if weights is None:
        deg = np.zeros(n, dtype=np.int64)
        if dst is not None and len(np.asarray(dst)):
            deg = np.bincount(
                np.asarray(dst, dtype=np.int64), minlength=n)[:n]
        weights = deg + 1
    w = np.asarray(weights, dtype=np.float64)
    if w.shape != (n,):
        raise ValueError(f"weights must be shape ({n},), got {w.shape}")
    cum = np.cumsum(w)
    total = cum[-1] if n else 0.0
    targets = total * np.arange(1, shards, dtype=np.float64) / shards
    cuts = np.searchsorted(cum, targets, side="left") + 1
    starts = np.concatenate([[0], np.minimum(cuts, n), [n]])
    starts = np.maximum.accumulate(starts).astype(np.int64)
    sizes = np.diff(starts)
    block = int(sizes.max()) if shards else n
    block = max(block, 1)
    return VertexPartition(n, shards, block, shards * block,
                           bounds=tuple(int(s) for s in starts))


def resolve_partition(spec, n: int, shards: int, dst=None) -> VertexPartition:
    """Resolve a partition request to a concrete `VertexPartition`:
    ``None``/``"equal"`` -> equal blocks, ``"balanced"`` -> edge-balanced
    (needs ``dst``), or pass a `VertexPartition` through (validated)."""
    if isinstance(spec, VertexPartition):
        if spec.n != int(n) or spec.shards != int(shards):
            raise ValueError(
                f"partition is for n={spec.n} shards={spec.shards}, "
                f"need n={n} shards={shards}")
        return spec
    if spec is None or spec == "equal":
        return vertex_partition(n, shards)
    if spec == "balanced":
        return balanced_vertex_partition(n, shards, dst=dst)
    raise ValueError(f"unknown partition spec {spec!r}")


def partition_edges_by_dst(src, dst, n_nodes: int, n_shards: int,
                           partition: VertexPartition = None):
    """Returns (src_slabs, dst_slabs, node_block) with shapes
    (n_shards, slab_len) int32; node_block is the padded tile width
    (``partition.block``, ceil(n/n_shards) for the default equal layout).

    dst ids in slab s are LOCAL to block s (0..node_block-1); padding edges
    carry local dst == node_block (dropped by segment_sum with
    num_segments=node_block).
    """
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    part = (partition if partition is not None
            else vertex_partition(n_nodes, n_shards))
    if part.shards != n_shards:
        raise ValueError(
            f"partition has {part.shards} shards, expected {n_shards}")
    node_block = part.block
    block_starts = part.starts
    shard_of = np.asarray(part.block_of(dst), dtype=np.int64)
    order = np.argsort(shard_of, kind="stable")
    src_s, dst_s, shard_s = src[order], dst[order], shard_of[order]
    counts = np.bincount(shard_s, minlength=n_shards)
    slab_len = int(counts.max()) if len(counts) else 1
    src_slabs = np.full((n_shards, slab_len), 0, dtype=np.int32)
    dst_slabs = np.full((n_shards, slab_len), node_block, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for s in range(n_shards):
        c = counts[s]
        sl = slice(starts[s], starts[s] + c)
        src_slabs[s, :c] = src_s[sl]
        dst_slabs[s, :c] = dst_s[sl] - block_starts[s]
    return src_slabs, dst_slabs, node_block


def balance_report(dst, n_nodes: int, n_shards: int,
                   partition: VertexPartition = None) -> dict:
    """Imbalance stats (max/mean dst-edges per shard) for a layout —
    the quantity `balanced_vertex_partition` minimizes."""
    part = (partition if partition is not None
            else vertex_partition(n_nodes, n_shards))
    dst = np.asarray(dst, dtype=np.int64)
    counts = np.bincount(np.asarray(part.block_of(dst), dtype=np.int64),
                         minlength=n_shards)
    mean = counts.mean() if counts.size else 0.0
    return {
        "max_edges": int(counts.max()) if counts.size else 0,
        "mean_edges": float(mean),
        "imbalance": float(counts.max() / max(mean, 1e-9))
        if counts.size else 1.0,
    }
