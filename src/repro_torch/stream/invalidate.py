"""Vertex -> RRR-row reverse-touch queries: which resident sets a delta
stales (``repro.stream.invalidate``).

The arena is its own reverse-touch index: column ``v`` of a bitmap
arena lists the rows whose traversal touched ``v``, and an index-list
row is the list of touched vertices.  A staleness query after a
`GraphDelta` is a masked column reduction — a gather of the touched
columns of a bitmap arena, ``decode_cols`` of an encoded one (the
compressed arena never expands), a vertex mask gathered at every list
entry of an index arena; on a meshed arena each tile answers for its
own block of columns and rows.

``invalidate(store, vertices)`` kills the touched rows through the
store's ``kill_rows``: they leave selection, ``hits`` and the fused
counter at once, while `repro_torch.stream.engine.StreamEngine.refresh`
repairs them.
"""
from __future__ import annotations

import numpy as np
import torch


def _touched_vertices(vertices, n: int) -> np.ndarray:
    verts = np.unique(np.asarray(vertices, np.int64))
    if verts.size and ((verts < 0).any() or (verts >= n).any()):
        raise ValueError(f"touched vertices out of range for n={n}")
    return verts


def rows_touching(store, vertices) -> torch.Tensor:
    """``(capacity,) bool``: the arena rows whose RRR traversal touched
    any of ``vertices`` (unfilled rows are all zero or all sentinel, so
    they never match), answered by the store's ``rows_touching``.  A
    `ShardedStore` answers tile by tile (each tile tests the touched
    vertices in its own column block against its own rows, hit bits
    or-ed over the vertex axis); its dead rows may match, and
    ``kill_rows`` ignores them."""
    verts = _touched_vertices(vertices, store.n)
    if not verts.size:
        return torch.zeros(store.capacity, dtype=torch.bool,
                           device=store.device)
    return store.rows_touching(verts)


def invalidate(store, vertices) -> int:
    """Mark every resident RRR set that touched ``vertices`` stale
    (dead): the conservative staleness set of a `GraphDelta` whose
    mutated-edge destinations are ``vertices``.  Returns the number of
    newly stale rows."""
    return store.kill_rows(rows_touching(store, vertices))
