"""GraphCast-style encode-process-decode mesh GNN (Lam et al. 2022;
``repro.models.gnn.graphcast``).

The processor: per layer, an edge update MLP([e, h_src, h_dst]) +
residual, a sum over each node's in-edges, a node update MLP([h, agg]) +
residual, a LayerNorm after each MLP (the MeshGraphNet/GraphCast recipe).
GraphCast's icosahedral multi-mesh (mesh_refinement 6) defines *which*
graph the processor runs on; on the assigned generic graph shapes it runs
on the given edge list.

The per-layer parameters are stacked on a leading L axis, as the
reference's ``jax.vmap(layer_init)`` makes them; ``jax.lax.scan`` is a
Python loop over the layers and ``jax.checkpoint`` is
``torch.utils.checkpoint`` (non-reentrant) around each layer, or around
each group of ``remat_group`` layers, when a gradient is being taken.
``dtype`` is the latents' dtype (bf16 for the big cells); the MLPs'
weights stay float32, and their products run in float32 as
``jnp.matmul`` promotes them.

`forward_edges_dst_partitioned` is the reference's ``shard_map``
processor on the port's `repro_torch.mesh.Mesh`: node blocks over the
data axes, edges pre-partitioned by dst block and split over
``"model"``, an all-gather of the node latents over the data axes every
layer (`repro_torch.mesh.all_gather_over`) and the partial aggregates
summed over ``"model"`` (`repro_torch.mesh.psum_over`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import mesh as M
from repro_torch.device import resolve_device
from repro_torch.graphs.partition import partition_edges_by_dst
from repro_torch.models.common import (
    layer_norm, layer_params, mlp_apply, mlp_init, stack_layers, tree_map,
)
from repro_torch.models.gnn.mpnn import gather_src, take_clip
from repro_torch.sparse.segment import segment_sum

TP = "model"


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    mesh_refinement: int = 6
    aggregator: str = "sum"
    n_vars: int = 227
    d_edge_in: int = 4           # edge geometric features
    remat: bool = True
    # checkpoint every ``remat_group`` layers: the saved (h, e) carries
    # shrink n_layers/remat_group-fold at the cost of recomputing one
    # group in the backward
    remat_group: int = 1
    dtype: str = "float32"       # latent dtype (bf16 for huge cells)
    # mesh axes of the node/edge latents (the reference's layout hints;
    # the dst-partitioned processor reads ``node_axes`` as its data axes)
    node_axes: tuple = ()
    edge_axes: tuple = ()


def init_graphcast(gen: torch.Generator, cfg: GraphCastConfig,
                   device=None) -> dict:
    """The reference's shapes and scales, drawn on ``gen``'s device and
    moved to ``device`` (``cuda`` unless told otherwise)."""
    dev = resolve_device(device)
    d = cfg.d_hidden

    def layer_init():
        ones = torch.ones((d,), device=gen.device)
        zeros = torch.zeros((d,), device=gen.device)
        return {"edge_mlp": mlp_init(gen, [3 * d, d, d]),
                "node_mlp": mlp_init(gen, [2 * d, d, d]),
                "ln_e": ones, "ln_e_b": zeros,
                "ln_n": ones.clone(), "ln_n_b": zeros.clone()}

    params = {"enc_node": mlp_init(gen, [cfg.n_vars, d, d]),
              "enc_edge": mlp_init(gen, [cfg.d_edge_in, d, d]),
              "dec": mlp_init(gen, [d, d, cfg.n_vars]),
              "layers": stack_layers([layer_init()
                                      for _ in range(cfg.n_layers)])}
    return tree_map(lambda t: t.to(dev), params)


def _remat_group(cfg: GraphCastConfig) -> int:
    g = max(int(cfg.remat_group), 1)
    if cfg.n_layers % g:
        raise ValueError(f"remat_group {g} does not divide n_layers "
                         f"{cfg.n_layers}")
    return g


def _processor_layer(h, e, p, *, edge_src, edge_dst, n_nodes):
    msg_in = torch.cat([e, gather_src(h, edge_src), gather_src(h, edge_dst)],
                       dim=-1)
    e_new = mlp_apply(p["edge_mlp"], msg_in).to(e.dtype)
    e = e + layer_norm(e_new, p["ln_e"], p["ln_e_b"]).to(e.dtype)
    agg = segment_sum(e, edge_dst, n_nodes)
    h_new = mlp_apply(p["node_mlp"], torch.cat([h, agg], dim=-1)).to(h.dtype)
    h = h + layer_norm(h_new, p["ln_n"], p["ln_n_b"]).to(h.dtype)
    return h, e


def forward_edges(params, cfg: GraphCastConfig, node_feats, edge_feats,
                  edge_src, edge_dst, n_nodes: int):
    """node_feats (N, n_vars), edge_feats (E, d_edge_in) -> (N, n_vars)."""
    dt = getattr(torch, cfg.dtype)
    g = _remat_group(cfg)
    h = mlp_apply(params["enc_node"], node_feats).to(dt)
    e = mlp_apply(params["enc_edge"], edge_feats).to(dt)

    def group(h, e, lo):
        for i in range(lo, lo + g):
            h, e = _processor_layer(
                h, e, layer_params(params["layers"], i), edge_src=edge_src,
                edge_dst=edge_dst, n_nodes=n_nodes)
        return h, e

    remat = cfg.remat and torch.is_grad_enabled()
    for lo in range(0, cfg.n_layers, g):
        h, e = (checkpoint(group, h, e, lo, use_reentrant=False) if remat
                else group(h, e, lo))
    return mlp_apply(params["dec"], h.to(torch.float32))


def loss_edges(params, cfg: GraphCastConfig, node_feats, edge_feats,
               edge_src, edge_dst, targets, n_nodes: int):
    pred = forward_edges(params, cfg, node_feats, edge_feats, edge_src,
                         edge_dst, n_nodes)
    return torch.mean(torch.square(pred - targets))


# ---------------------------------------- dst-partitioned (production) ----

def forward_edges_dst_partitioned(params, cfg: GraphCastConfig, node_feats,
                                  edge_feats, edge_src, edge_dst_local,
                                  n_nodes: int, *, mesh):
    """The processor on ``mesh`` (axes ``cfg.node_axes`` + ``"model"``),
    honouring the paper's C2 layout:

      * nodes block-partitioned over the data axes ``cfg.node_axes``
        (row-major; ``node_feats``' N rows split into equal blocks),
      * edges pre-partitioned by DST block (`repro_torch.graphs.partition.
        partition_edges_by_dst`): data block ``i``'s slab is the ``i``-th
        equal part of the edge arrays, split in turn into equal parts over
        ``"model"``, so every tile's segment sum writes only its local
        node block and the partial aggregates are summed over ``"model"``,
      * every layer all-gathers the node latents over the data axes.

    ``edge_dst_local``: dst ids LOCAL to the owning block (the sentinel,
    the block's size, drops).  Returns ``(N, n_vars)`` on
    ``node_feats``' device, the blocks in data order."""
    dp = tuple(cfg.node_axes)
    if sorted(mesh.axis_names) != sorted(dp + (TP,)):
        raise ValueError(f"the dst-partitioned processor needs a mesh over "
                         f"{dp} and {TP!r}, got {mesh.axis_names}")
    n_dp = int(np.prod([mesh.shape[a] for a in dp]))
    n_tiles = n_dp * mesh.shape[TP]
    N, E = node_feats.shape[0], edge_src.shape[0]
    if N % n_dp or E % n_tiles:
        raise ValueError(f"{N} nodes over {n_dp} data blocks and {E} edges "
                         f"over {n_tiles} tiles: each must divide")
    nb, eb = N // n_dp, E // n_tiles
    dt = getattr(torch, cfg.dtype)
    g = _remat_group(cfg)
    coords = list(np.ndindex(*mesh.devices.shape))
    dev = {c: mesh.devices[c] for c in coords}
    blk = {c: M.axis_index(mesh, c, dp) for c in coords}
    chunk = {c: M.axis_index(mesh, c, dp + (TP,)) for c in coords}

    def rows(x, c, size, at):
        return x[at * size:(at + 1) * size].to(dev[c])

    es = {c: rows(edge_src, c, eb, chunk[c]) for c in coords}
    ed = {c: rows(edge_dst_local, c, eb, chunk[c]) for c in coords}
    ed_clip = {c: torch.clamp(ed[c], 0, nb - 1) for c in coords}

    def tile_params(tree, c):
        return tree_map(lambda t: t.to(dev[c]), tree)

    h = {c: mlp_apply(tile_params(params["enc_node"], c),
                      rows(node_feats, c, nb, blk[c])).to(dt)
         for c in coords}
    e = {c: mlp_apply(tile_params(params["enc_edge"], c),
                      rows(edge_feats, c, eb, chunk[c])).to(dt)
         for c in coords}

    def tiles(d):
        return M.tile_map(mesh, lambda c, _: d[c])

    def layer(h, e, i):
        h_full = M.all_gather_over(mesh, tiles(h), dp, dim=0)
        p = {c: tile_params(layer_params(params["layers"], i), c)
             for c in coords}
        e_out, agg = {}, {}
        for c in coords:
            msg_in = torch.cat([e[c], take_clip(h_full[c], es[c]),
                                h[c].index_select(0, ed_clip[c].long())],
                               dim=-1)
            e_new = mlp_apply(p[c]["edge_mlp"], msg_in).to(dt)
            e_out[c] = e[c] + layer_norm(e_new, p[c]["ln_e"],
                                         p[c]["ln_e_b"]).to(dt)
            agg[c] = segment_sum(e_out[c], ed[c], nb)
        agg = M.psum_over(mesh, tiles(agg), TP)            # model partials
        h_out = {}
        for c in coords:
            h_new = mlp_apply(p[c]["node_mlp"], torch.cat(
                [h[c], agg[c].to(dt)], dim=-1)).to(dt)
            h_out[c] = h[c] + layer_norm(h_new, p[c]["ln_n"],
                                         p[c]["ln_n_b"]).to(dt)
        return h_out, e_out

    k = len(coords)

    def group(lo, *flat):
        hh, ee = dict(zip(coords, flat[:k])), dict(zip(coords, flat[k:]))
        for i in range(lo, lo + g):
            hh, ee = layer(hh, ee, i)
        return tuple(hh[c] for c in coords) + tuple(ee[c] for c in coords)

    remat = cfg.remat and torch.is_grad_enabled()
    for lo in range(0, cfg.n_layers, g):
        flat = [h[c] for c in coords] + [e[c] for c in coords]
        out = (checkpoint(group, lo, *flat, use_reentrant=False) if remat
               else group(lo, *flat))
        h, e = dict(zip(coords, out[:k])), dict(zip(coords, out[k:]))

    # out_specs P(dp, None): one tile a data block, in data order
    first = {}
    for c in coords:
        first.setdefault(blk[c], c)
    dec = [mlp_apply(tile_params(params["dec"], first[b]),
                     h[first[b]].to(torch.float32)).to(node_feats.device)
           for b in range(n_dp)]
    return torch.cat(dec, dim=0)


def partition_edges(edge_src, edge_dst, edge_feats, n_nodes: int,
                    n_dp: int, n_tp: int):
    """``(edge_feats, edge_src, edge_dst_local)`` in the layout
    `forward_edges_dst_partitioned` reads, on ``edge_feats``' device: the
    edges partitioned by dst block over ``n_dp`` data blocks
    (``partition_edges_by_dst``, equal blocks of ``ceil(n_nodes /
    n_dp)``), each slab padded to a multiple of ``n_tp`` with edges from
    node 0 to the local sentinel (the block size) with zero features,
    the slabs laid end to end."""
    src = edge_src.detach().cpu().numpy()
    dst = edge_dst.detach().cpu().numpy()
    src_s, dst_s, nb = partition_edges_by_dst(src, dst, n_nodes, n_dp)
    # partition_edges_by_dst's own order: a stable sort by dst block
    order = np.argsort(np.minimum(dst // nb, n_dp - 1), kind="stable")
    counts = np.bincount(np.minimum(dst // nb, n_dp - 1), minlength=n_dp)
    slab = -(-src_s.shape[1] // n_tp) * n_tp
    es = np.zeros((n_dp, slab), np.int64)
    ed = np.full((n_dp, slab), nb, np.int64)
    es[:, :src_s.shape[1]], ed[:, :dst_s.shape[1]] = src_s, dst_s
    rows = np.zeros((n_dp, slab), np.int64)
    valid = np.zeros((n_dp, slab), bool)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for b in range(n_dp):
        rows[b, :counts[b]] = order[starts[b]:starts[b + 1]]
        valid[b, :counts[b]] = True
    dev = edge_feats.device
    rows, valid = (torch.from_numpy(a.reshape(-1)).to(dev)
                   for a in (rows, valid))
    ef = edge_feats.index_select(0, rows) * valid[:, None]
    return (ef, torch.from_numpy(es.reshape(-1)).to(dev),
            torch.from_numpy(ed.reshape(-1)).to(dev))


def loss_edges_dst_partitioned(params, cfg, node_feats, edge_feats,
                               edge_src, edge_dst_local, targets,
                               n_nodes: int, *, mesh):
    pred = forward_edges_dst_partitioned(
        params, cfg, node_feats, edge_feats, edge_src, edge_dst_local,
        n_nodes, mesh=mesh)
    return torch.mean(torch.square(pred - targets))
