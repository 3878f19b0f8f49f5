"""Vertex -> RRR-row reverse-touch queries: which resident sets a delta
stales (``repro.stream.invalidate``).

The arena is its own reverse-touch index: column ``v`` of a bitmap
arena lists the rows whose traversal touched ``v``, and an index-list
row is the list of touched vertices.  A staleness query after a
`GraphDelta` is a masked column reduction — a gather of the touched
columns of a bitmap arena, ``decode_cols`` of an encoded one (the
compressed arena never expands), a vertex mask gathered at every list
entry of an index arena.

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
    they never match)."""
    verts = _touched_vertices(vertices, store.n)
    R = store.R
    if not verts.size:
        return torch.zeros(R.shape[0], dtype=torch.bool, device=R.device)
    v = torch.as_tensor(verts, device=R.device)
    rep = store.representation
    if rep in ("packed", "compressed"):
        return store.codec.decode_cols(R, v).any(dim=1)
    if rep == "bitmap":
        return (R.index_select(1, v) > 0).any(dim=1)
    mask = torch.zeros(store.n + 1, dtype=torch.bool, device=R.device)
    mask[v] = True
    return mask.index_select(0, R.reshape(-1).long()).view(
        R.shape).any(dim=1)


def invalidate(store, vertices) -> int:
    """Mark every resident RRR set that touched ``vertices`` stale
    (dead): the conservative staleness set of a `GraphDelta` whose
    mutated-edge destinations are ``vertices``.  Returns the number of
    newly stale rows."""
    return store.kill_rows(rows_touching(store, vertices))
