"""Shared message-passing utilities (``repro.models.gnn.mpnn``).

All GNN aggregation reduces to gather(src) -> reduce-by-dst, the same
primitive as the EfficientIMM counter update.  Two modes:

  * a flat edge list (full-graph training): `gather_src` + `aggregate`;
  * edges partitioned by dst block (`repro_torch.graphs.partition.
    partition_edges_by_dst`) on a `repro_torch.mesh.Mesh`
    (`sharded_aggregate`): each tile gathers the src rows of its slab
    from the whole node table and reduces them into its own dst block,
    the IMM partial-counter pattern.  The reference runs that body inside
    ``shard_map``; here one process holds the mesh and runs it tile by
    tile, each on its tile's device.
"""
from __future__ import annotations

import torch

from repro_torch import mesh as M
from repro_torch.models.common import take_index, take_rows
from repro_torch.sparse.segment import segment_max, segment_mean, segment_sum


def gather_src(h: torch.Tensor, edge_src: torch.Tensor) -> torch.Tensor:
    """``jnp.take(h, edge_src, axis=0)``: rows of ``h``, a negative id
    wrapping once, a NaN row for an id outside ``[-n, n)``."""
    safe, invalid = take_index(edge_src.to(h.device), h.shape[0])
    return take_rows(h, safe, invalid)


def take_clip(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(x, idx, axis=0, mode="clip")``: ids clamped to
    ``[0, n - 1]``."""
    safe = torch.clamp(idx.to(device=x.device, dtype=torch.int64), 0,
                       x.shape[0] - 1)
    return x.index_select(0, safe.reshape(-1)).view(*idx.shape,
                                                    *x.shape[1:])


def aggregate(messages: torch.Tensor, edge_dst, n_nodes: int,
              op: str = "sum") -> torch.Tensor:
    """Messages reduced into ``n_nodes`` rows by ``edge_dst`` (``sum``,
    ``mean`` or ``max``; an empty max gives 0); ids outside ``[0,
    n_nodes)`` (the sentinel ``n_nodes``) are dropped."""
    if op == "sum":
        return segment_sum(messages, edge_dst, n_nodes)
    if op == "mean":
        return segment_mean(messages, edge_dst, n_nodes)
    if op == "max":
        out = segment_max(messages, edge_dst, n_nodes)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    raise ValueError(op)


def sharded_aggregate(mesh, h_global: torch.Tensor, msg_fn, src_slabs,
                      dst_slabs, node_block: int, *, axis_name,
                      op: str = "sum") -> torch.Tensor:
    """`aggregate` over dst-partitioned edges on ``mesh``.

    ``src_slabs``/``dst_slabs`` are ``(n_shards, slab_len)``, as
    ``partition_edges_by_dst`` makes them, with one shard a tile along
    ``axis_name`` (a name or a tuple of names, row-major): slab ``s``
    holds global src ids and dst ids local to block ``s`` (the padding id
    ``node_block`` drops).  Tile ``s`` gathers its src rows from
    ``h_global`` (the whole node table, as the reference's all-gathered
    one), applies ``msg_fn`` and reduces them into its ``node_block``
    rows on its own device; tiles that differ only off ``axis_name``
    compute the same block.  Returns the blocks in shard order, ``(n_shards
    * node_block, ...)``, on ``h_global``'s device."""
    n_shards = src_slabs.shape[0]

    def tile(c, dev):
        s = M.axis_index(mesh, c, axis_name)
        msgs = msg_fn(gather_src(h_global.to(dev), src_slabs[s].to(dev)))
        return aggregate(msgs, dst_slabs[s].to(dev), node_block, op)

    parts = M.tile_map(mesh, tile)
    blocks = {}
    for c in M.axis_groups(mesh, axis_name)[0]:
        blocks[M.axis_index(mesh, c, axis_name)] = parts[c]
    if sorted(blocks) != list(range(n_shards)):
        raise ValueError(f"{n_shards} slabs for {len(blocks)} tiles along "
                         f"{axis_name!r}")
    return torch.cat([blocks[s].to(h_global.device)
                      for s in range(n_shards)])
