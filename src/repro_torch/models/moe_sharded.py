"""The meshed MoE FFN (``repro.models.moe_sharded``) on the port's `Mesh`.

The reference pins the whole dispatch, expert compute and combine per
device inside a ``shard_map``.  Here one process holds the mesh
(`repro_torch.mesh`): each tile's slice of the tokens is a tensor on the
tile's device, and the collectives are the mesh's grouped ones over the
tiles that share a coordinate.

* Routing and capacity are **local**: each tile routes its own tokens
  with ``C_loc = max(int(cf * k * T_loc / E), 1)`` slots an expert, as
  the reference does (the global-capacity `_moe_ffn` stays the
  single-device path).  The reference's ``_local_dispatch`` and
  ``_local_combine`` are `repro_torch.models.moe`'s ``route`` +
  ``dispatch`` and ``combine``, which the single-device FFN uses too.
* ``"ep"`` (experts over ``"model"``, moonshot's 64): the ``(E, C_loc,
  d)`` slots move to their expert block's tile with an `all_to_all` over
  ``"model"``, run there and come back the same way.
* ``"tpe"`` (each expert's ff axis over ``"model"``, grok's 8): a tile
  gathers its data row's sequence over ``"model"`` (every tile of the
  row dispatches the same tokens), runs every expert over its ff block,
  psums the down projection's partial sums over ``"model"`` and slices
  its sequence block back out.  Its ff block holds the gate columns and
  the up columns of that block (``w_gate_up[..., j f:(j+1) f]`` and
  ``[..., ff + j f: ff + (j+1) f]``), so that the gate and up halves stay
  paired on every tile.

The tokens ``x (B, S, d)`` are split as the reference's ``P(dp,
"model", None)``: the batch over the data axes ``cfg.moe_shard_axes``
(row-major), the sequence over ``"model"``; the mesh's axes are those
and no other.  The weights are sliced per tile from the whole tensors
(the reference stores their ``d`` axis split over the data axes and
re-gathers it every layer; one process holds them whole).  The output
is gathered back to ``x``'s device in ``x``'s dtype, with the aux loss
of every tile's routing psum'd over the mesh.

``MESH`` is set by the caller before a forward, as the reference's
launcher sets it: `LMConfig` stays frozen and the transformer's layer
takes no mesh argument.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import mesh as M
from repro_torch.models import moe

#: the `repro_torch.mesh.Mesh` the meshed MoE runs on (set by the caller)
MESH = None

TP = "model"


def _aux_loss(routings: np.ndarray, E: int, device) -> torch.Tensor:
    """The load-balance loss over every tile's routing: the expert
    counts, the probability sums and the token counts psum'd over the
    mesh in tile order, on ``device``."""
    tiles = [routings[c] for c in np.ndindex(*routings.shape)]
    density = M.psum([torch.bincount(r.flat_eid, minlength=E).to(
        torch.float32) for r in tiles], device)
    pmean = M.psum([r.probs.sum(dim=0) for r in tiles], device)
    t_tot = float(sum(r.probs.shape[0] for r in tiles))
    return E * torch.sum((density / t_tot) * (pmean / t_tot))


def _check(mesh, cfg, x) -> tuple:
    if mesh is None:
        raise RuntimeError("moe_sharded.MESH is not set: the caller sets "
                           "the mesh before a meshed MoE forward")
    dp = tuple(cfg.moe_shard_axes)
    if sorted(mesh.axis_names) != sorted(dp + (TP,)):
        raise ValueError(f"the meshed MoE needs a mesh over the data axes "
                         f"{dp} and {TP!r}, got {mesh.axis_names}")
    if cfg.moe_partition not in ("ep", "tpe"):
        raise ValueError(f"moe_partition must be ep|tpe, got "
                         f"{cfg.moe_partition!r}")
    B, S, _ = x.shape
    n_dp = int(np.prod([mesh.shape[a] for a in dp]))
    n_tp = mesh.shape[TP]
    split = cfg.n_experts if cfg.moe_partition == "ep" else cfg.d_ff
    what = "experts" if cfg.moe_partition == "ep" else "d_ff"
    if B % n_dp or S % n_tp or split % n_tp:
        raise ValueError(f"the meshed MoE splits B {B} over {n_dp} data "
                         f"tiles, S {S} and {what} {split} over {n_tp} "
                         f"model tiles: each must divide")
    return dp, B // n_dp, S // n_tp


def moe_ffn_sharded(p: dict, x: torch.Tensor, cfg):
    """``x (B, S, d) -> (y (B, S, d), aux ())`` on ``MESH``, ``p`` one
    layer's router ``(d, E)``, ``w_gate_up (E, d, 2 ff)`` and ``w_down
    (E, ff, d)``."""
    mesh = MESH
    dp, Bl, Sl = _check(mesh, cfg, x)
    E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    ep = cfg.moe_partition == "ep"
    n_tp = mesh.shape[TP]
    tp_at = mesh.axis_names.index(TP)
    d = x.shape[-1]

    def x_tile(c, dev):
        i, j = M.axis_index(mesh, c, dp), c[tp_at]
        return x[i * Bl:(i + 1) * Bl, j * Sl:(j + 1) * Sl].to(dev)

    x_loc = M.tile_map(mesh, x_tile)
    if not ep:
        # every tile of a data row dispatches the same tokens: gather the
        # row's sequence over "model" first
        x_loc = M.all_gather_over(mesh, x_loc, TP, dim=1)
    routing = M.tile_map(mesh, lambda c, dev: moe.route(
        x_loc[c].reshape(-1, d), p["router"].to(dev), E, k, cf))
    xe = M.tile_map(mesh, lambda c, dev: moe.dispatch(
        x_loc[c].reshape(-1, d), routing[c]))

    if ep:
        eb = E // n_tp
        xe = M.all_to_all_over(mesh, xe, TP, split_axis=0, concat_axis=1)
        ye = M.tile_map(mesh, lambda c, dev: moe.experts(
            xe[c], p["w_gate_up"][c[tp_at] * eb:(c[tp_at] + 1) * eb].to(dev),
            p["w_down"][c[tp_at] * eb:(c[tp_at] + 1) * eb].to(dev)))
        ye = M.all_to_all_over(mesh, ye, TP, split_axis=1, concat_axis=0)
    else:
        f = cfg.d_ff // n_tp

        def partial(c, dev):
            lo, hi = c[tp_at] * f, (c[tp_at] + 1) * f
            wgu = p["w_gate_up"]
            # one model tile holds the whole ff axis: its block is the
            # weight itself, so no copy of it is made
            gate_up = wgu if n_tp == 1 else torch.cat(
                [wgu[..., lo:hi], wgu[..., cfg.d_ff + lo:cfg.d_ff + hi]], -1)
            return moe.experts(xe[c], gate_up.to(dev),
                               p["w_down"][:, lo:hi].to(dev))

        ye = M.psum_over(mesh, M.tile_map(mesh, partial), TP)

    def y_tile(c, dev):
        y = moe.combine(ye[c], routing[c])
        if ep:
            return y.view(Bl, Sl, d)
        j = c[tp_at]
        return y.view(Bl, Sl * n_tp, d)[:, j * Sl:(j + 1) * Sl]

    y_loc = M.tile_map(mesh, y_tile)
    rows = []
    for i in range(int(np.prod([mesh.shape[a] for a in dp]))):
        blocks = {}
        for c in np.ndindex(*y_loc.shape):
            if M.axis_index(mesh, c, dp) == i:
                blocks[c[tp_at]] = y_loc[c].to(x.device)
        rows.append(torch.cat([blocks[j] for j in range(n_tp)], dim=1))
    y = torch.cat(rows, dim=0).to(x.dtype)
    return y, _aux_loss(routing, E, x.device)
