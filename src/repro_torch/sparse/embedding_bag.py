"""EmbeddingBag built from gather + segment reduce
(``repro.sparse.embedding_bag``).

Two variants:
  * `embedding_bag`: one device, ``index_select`` + a segment reduce;
  * `sharded_embedding_lookup`: the table row-sharded over a mesh axis of
    a `repro_torch.mesh.Mesh` (the recsys "huge table" case and the
    paper's NUMA-interleaving analogue): every tile gathers the rows it
    owns (the others contribute zero) and the partials are summed over
    the axis in tile order, the EfficientIMM partial-counter reduction.
    The reference runs that body inside ``shard_map``; here one process
    runs it tile by tile (`row_shards` splits a table into the tiles'
    blocks).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import mesh as M
from repro_torch.sparse.segment import segment_max, segment_mean, segment_sum


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, offsets=None,
                  mode: str = "sum") -> torch.Tensor:
    """``torch.nn.EmbeddingBag`` semantics, as the reference computes them.

    table: (vocab, dim).  indices: (nnz,) int.  offsets: (bags,) the start
    of each bag in ``indices`` (None: ``indices`` is (bags, fixed_len)
    multi-hot).  An index outside ``[0, vocab)`` (the padding id
    ``vocab``) contributes a zero row; an empty bag gives zeros in every
    mode.
    """
    vocab, dim = table.shape
    dev = table.device
    indices = indices.to(dev)
    if offsets is None:
        bags, length = indices.shape
        flat = indices.reshape(-1)
        seg = torch.arange(bags, dtype=torch.int64,
                           device=dev).repeat_interleave(length)
    else:
        offsets = offsets.to(dev)
        bags = offsets.shape[0]
        positions = torch.arange(indices.shape[0], dtype=offsets.dtype,
                                 device=dev)
        seg = torch.searchsorted(offsets, positions, right=True) - 1
        flat = indices
    safe = torch.clamp(flat.to(torch.int64), 0, vocab - 1)
    rows = table.index_select(0, safe)
    valid = ((flat >= 0) & (flat < vocab))[:, None]
    if mode == "sum":
        return segment_sum(rows.masked_fill(~valid, 0.0), seg, bags)
    if mode == "mean":
        return segment_mean(rows.masked_fill(~valid, 0.0), seg, bags)
    if mode == "max":
        out = segment_max(rows.masked_fill(~valid, -torch.inf), seg, bags)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    raise ValueError(f"unknown mode {mode}")


def row_shards(mesh, table: torch.Tensor, axis_name):
    """``table``'s row blocks as the tiles of ``mesh`` hold them, row-
    sharded over ``axis_name`` (``P(axis_name, None)``): an object ndarray
    of the mesh's shape, tile ``c`` holding block ``axis_index(c)`` of
    ``table.shape[0] / shards`` rows on its device."""
    shards = len(M.axis_groups(mesh, axis_name)[0])
    if table.shape[0] % shards:
        raise ValueError(f"{table.shape[0]} rows do not split into "
                         f"{shards} shards")
    rows = table.shape[0] // shards

    def tile(c, dev):
        s = M.axis_index(mesh, c, axis_name)
        return table[s * rows:(s + 1) * rows].to(dev)

    return M.tile_map(mesh, tile)


def sharded_embedding_lookup(local_tables, global_indices: torch.Tensor, *,
                             mesh, axis_name, shard_rows: int):
    """Rows of a table row-sharded over ``axis_name``.

    ``local_tables``: an object ndarray of the mesh's shape, tile ``c``'s
    ``(shard_rows, dim)`` block of contiguous rows (`row_shards`).
    ``global_indices``: any int shape of *global* row ids, or an object
    ndarray of the mesh's shape holding each tile's own ids (the block a
    ``shard_map`` hands each tile; the tiles of a group along
    ``axis_name`` hold ids of one shape).  Returns, as an object ndarray
    of the mesh's shape, every tile's ``(*ids.shape, dim)`` gathered rows,
    summed over ``axis_name`` in tile order (an id no tile owns gives
    zeros)."""
    def tile(c, dev):
        lo = M.axis_index(mesh, c, axis_name) * shard_rows
        ids = (global_indices[c] if isinstance(global_indices, np.ndarray)
               else global_indices)
        local_ids = ids.to(device=dev, dtype=torch.int64) - lo
        hit = (local_ids >= 0) & (local_ids < shard_rows)
        safe = torch.clamp(local_ids, 0, shard_rows - 1)
        rows = local_tables[c].index_select(0, safe.reshape(-1)).view(
            *safe.shape, local_tables[c].shape[-1])
        return rows.masked_fill(~hit[..., None], 0.0)

    return M.psum_over(mesh, M.tile_map(mesh, tile), axis_name)
