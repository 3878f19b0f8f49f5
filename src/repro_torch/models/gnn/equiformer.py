"""Equiformer-v2-style equivariant graph attention via eSCN SO(2) convs
(Liao et al. 2023 / Passaro & Zitnick 2023; ``repro.models.gnn.
equiformer``).

Node features are real-SH irrep stacks X: (N, S, C) with S = (l_max+1)^2.
Per layer, per edge:
  1. per-l linear mix of src/dst features,
  2. rotate into the edge-aligned frame (exact Wigner D from irreps.py),
  3. SO(2) convolution truncated at m_max (the eSCN O(L^6) -> O(L^3) trick),
     with radial-basis gating,
  4. rotate back, attention weights from the invariant (l=0) channel,
     aggregate, per-l node update + invariant-gated FFN.

Attention normalization uses soft-capped logits (``logit_cap * tanh``)
followed by a plain exp-sum: segment-softmax's value (the cap bounds the
exponent) in ONE pass over edges.  That single-pass form allows **edge
chunking**: with ``edge_src/edge_dst`` given as (n_chunks, chunk) the
layer loops over edge blocks, accumulating the weighted message numerator
and the attention denominator into node buffers, so the per-edge
(chunk, S, C) irrep tensors never exist all at once.

The simplification of the released model is the reference's: the SO(2)
weights are static parameters modulated by a radial MLP gate instead of
fully edge-generated weights.

The port computes each edge's geometry (its Wigner stack, radial basis
and validity) once a forward and hands it to every layer: the reference
recomputes the same values in each layer, from inputs that carry no
gradient.  Outputs of the SO(2) convolution and the seeded irrep stack
are assembled out of place (``index_copy``, ``cat``), so autograd keeps
every path; the m index sets are built once a device.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.common import (
    dense_init, layer_params, mlp_apply, mlp_init, stack_layers, tree_map,
)
from repro_torch.models.gnn.irreps import (
    l_slices, num_sph, rotation_to_align_z, sph_harm_from_wigner,
    wigner_d_stack,
)
from repro_torch.models.gnn.mpnn import take_clip
from repro_torch.sparse.segment import segment_sum


@dataclasses.dataclass(frozen=True)
class EquiformerConfig:
    name: str = "equiformer_v2"
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    d_feat: int = 16
    n_rbf: int = 8
    n_out: int = 1
    cutoff: float = 5.0
    logit_cap: float = 10.0      # tanh soft cap -> single-pass attention
    dtype: str = "float32"       # irrep feature dtype (bf16 for huge cells)
    remat: bool = True
    # mesh axes of the irrep stacks (the reference's layout hints)
    node_axes: tuple = ()
    channel_axis: str = ""


def _m_index_lists(l_max: int, m_max: int):
    """For each m in 0..m_max: flat indices of (l, +m) and (l, -m), l >= m."""
    sl = l_slices(l_max)
    return [([s + l + m for s, e, l in sl if l >= m],
              [s + l - m for s, e, l in sl if l >= m])
            for m in range(m_max + 1)]


@lru_cache(maxsize=None)
def _m_index_sets(l_max: int, m_max: int, device: torch.device):
    """`_m_index_lists` as int64 tensors on ``device``, and the order in
    which `_so2_conv` writes its outputs (m = 0's +m set, then each
    m > 0's +m and -m sets), built once a device."""
    lists = _m_index_lists(l_max, m_max)
    sets = [(torch.tensor(p, device=device), torch.tensor(q, device=device))
            for p, q in lists]
    order = [i for m, (p, q) in enumerate(lists) for i in (p if m == 0
                                                           else p + q)]
    return sets, torch.tensor(order, device=device)


def init_equiformer(gen: torch.Generator, cfg: EquiformerConfig,
                    device=None) -> dict:
    """The reference's shapes and scales (layers stacked on a leading L
    axis), drawn on ``gen``'s device and moved to ``device`` (``cuda``
    unless told otherwise)."""
    dev = resolve_device(device)
    C, L = cfg.d_hidden, cfg.l_max
    n_l = L + 1

    def layer_init():
        p = {
            # per-l channel mixers for src/dst/aggregate/update
            "w_src": dense_init(gen, C, C, lead=(n_l,)),
            "w_dst": dense_init(gen, C, C, lead=(n_l,)),
            "w_upd": dense_init(gen, C, C, lead=(n_l,)),
            "attn_mlp": mlp_init(gen, [C + cfg.n_rbf, C, cfg.n_heads]),
            "rad_mlp": mlp_init(gen, [cfg.n_rbf, C, n_l]),
            "gate_mlp": mlp_init(gen, [C, C, n_l * C]),
            "ffn0": mlp_init(gen, [C, 2 * C, C]),
        }
        # SO(2) conv weights per m
        for m in range(cfg.m_max + 1):
            n_lm = L + 1 - m
            scale = 1.0 / math.sqrt(n_lm * C)
            p[f"so2_A{m}"] = dense_init(gen, n_lm * C, n_lm * C, scale=scale)
            if m > 0:
                p[f"so2_B{m}"] = dense_init(gen, n_lm * C, n_lm * C,
                                            scale=scale)
        return p

    params = {"embed": mlp_init(gen, [cfg.d_feat, C]),
              "out": mlp_init(gen, [C, C, cfg.n_out]),
              "layers": stack_layers([layer_init()
                                      for _ in range(cfg.n_layers)])}
    return tree_map(lambda t: t.to(dev), params)


def _per_l_linear(w_stack, X, l_max: int):
    """w_stack (n_l, C, C); X (..., S, C) -> per-l block matmul."""
    return torch.cat([X[..., s:e, :] @ w_stack[l].to(X.dtype)
                      for s, e, l in l_slices(l_max)], dim=-2)


def _rotate(D, X, l_max: int, transpose: bool = False):
    """Apply the block-diagonal Wigner stack to (..., S, C)."""
    outs = []
    for (s, e, l), Dl in zip(l_slices(l_max), D):
        Dl = Dl.to(X.dtype)
        outs.append((Dl.transpose(-1, -2) if transpose else Dl)
                    @ X[..., s:e, :])
    return torch.cat(outs, dim=-2)


def _rbf(dist, n_rbf: int, cutoff: float):
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=dist.dtype,
                             device=dist.device)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * torch.square(dist[..., None] - centers))


def _so2_conv(p, Z, cfg: EquiformerConfig, m_sets, rad_gate):
    """Z: (E, S, C) aligned features -> (E, S, C), |m| > m_max zeroed.

    rad_gate: (E, n_l) radial modulation applied per output l block.
    """
    E = Z.shape[0]
    C, L = cfg.d_hidden, cfg.l_max
    sets, order = m_sets
    pieces = []
    for m, (ip, im) in enumerate(sets):
        n_lm = ip.shape[0]
        xp = Z.index_select(1, ip).reshape(E, n_lm * C)
        A = p[f"so2_A{m}"].to(Z.dtype)
        if m == 0:
            pieces.append((xp @ A).reshape(E, n_lm, C))
        else:
            xm = Z.index_select(1, im).reshape(E, n_lm * C)
            B = p[f"so2_B{m}"].to(Z.dtype)
            pieces.append((xp @ A - xm @ B).reshape(E, n_lm, C))
            pieces.append((xp @ B + xm @ A).reshape(E, n_lm, C))
    out = torch.zeros_like(Z).index_copy(1, order, torch.cat(pieces, 1))
    # radial gating per l block
    return torch.cat([out[:, s:e, :] * rad_gate[:, None, l:l + 1].to(Z.dtype)
                      for s, e, l in l_slices(L)], dim=1)


def _edge_geometry(cfg: EquiformerConfig, pos, es, ed):
    """One block of edges' geometry, the same in every layer: the Wigner
    stack of the rotation that aligns each edge with z, the radial basis
    and whether the edge has a length (padding and zero-length edges get
    weight 0)."""
    evec = take_clip(pos, ed) - take_clip(pos, es)
    dist = torch.linalg.norm(evec, dim=-1)
    return {"D": wigner_d_stack(rotation_to_align_z(evec), cfg.l_max),
            "rbf": _rbf(dist, cfg.n_rbf, cfg.cutoff),
            "valid": dist > 1e-6}


def _edge_block(p, cfg: EquiformerConfig, X, geo, es, ed, m_sets):
    """Messages + attention weights for one block of edges (``geo`` its
    `_edge_geometry`).

    Returns (weighted messages (e, S, C), weights (e, heads), dst ids).
    Zero-length/padding edges get weight 0 (their dst may be the sentinel
    n_nodes, dropped by segment_sum).
    """
    L = cfg.l_max
    D, rbf = geo["D"], geo["rbf"]
    Xs, Xd = take_clip(X, es), take_clip(X, ed)
    msg = _per_l_linear(p["w_src"], Xs, L) + _per_l_linear(p["w_dst"], Xd, L)
    Z = _rotate(D, msg, L)                                # edge-aligned
    rad_gate = mlp_apply(p["rad_mlp"], rbf)               # (e, n_l)
    Zc = _so2_conv(p, Z, cfg, m_sets, rad_gate)
    msg_out = _rotate(D, Zc, L, transpose=True)           # back to global

    # soft-capped attention logits -> single-pass exp weights
    inv = torch.cat([Zc[:, 0, :], rbf.to(Zc.dtype)], dim=-1)
    logits = mlp_apply(p["attn_mlp"], inv).to(torch.float32)
    cap = cfg.logit_cap
    logits = cap * torch.tanh(logits / cap)
    w = torch.exp(logits) * geo["valid"][:, None]         # (e, heads)

    e_, S, C = msg_out.shape
    mh = msg_out.reshape(e_, S, cfg.n_heads, C // cfg.n_heads)
    num = (mh * w[:, None, :, None].to(mh.dtype)).reshape(e_, S, C)
    return num, w, ed


def forward_edges(params, cfg: EquiformerConfig, node_feats, pos, edge_src,
                  edge_dst, n_nodes: int):
    """-> (invariant node embeddings (N, C), per-node outputs (N, n_out)).

    edge_src/edge_dst: (E,) flat, or (n_chunks, chunk) for the chunked
    aggregation path (huge graphs; see the module's docstring).
    """
    C, L, S = cfg.d_hidden, cfg.l_max, num_sph(cfg.l_max)
    H = cfg.n_heads
    m_sets = _m_index_sets(cfg.l_max, cfg.m_max, node_feats.device)
    dt = getattr(torch, cfg.dtype)
    chunks = (list(zip(edge_src.unbind(0), edge_dst.unbind(0)))
              if edge_src.ndim == 2 else [(edge_src, edge_dst)])

    # init: l=0 from node features; higher l seeded by neighbour geometry
    h0 = mlp_apply(params["embed"], node_feats).to(dt)    # (N, C)

    def seed_block(es, ed):
        evec = take_clip(pos, ed) - take_clip(pos, es)
        valid = torch.linalg.norm(evec, dim=-1) > 1e-6
        sh = sph_harm_from_wigner(evec, L) * valid[:, None]   # (e, S)
        src_h = take_clip(h0, es)
        return segment_sum((sh[:, :, None] * src_h[:, None, :]).to(dt), ed,
                           n_nodes)

    geo = seed_block(*chunks[0])
    for es, ed in chunks[1:]:
        geo = geo + seed_block(es, ed)
    X = torch.cat([h0[:, None, :], h0.new_zeros((n_nodes, S - 1, C))], 1)
    X = X + geo / float(np.float32(np.sqrt(np.float32(S))))
    geos = [_edge_geometry(cfg, pos, es, ed) for es, ed in chunks]

    def aggregate(p, X):
        num = torch.zeros((n_nodes, S, C), dtype=dt, device=X.device)
        den = torch.zeros((n_nodes, H), dtype=torch.float32, device=X.device)
        for (es, ed), g in zip(chunks, geos):
            num_e, w, ed = _edge_block(p, cfg, X, g, es, ed, m_sets)
            num = num + segment_sum(num_e, ed, n_nodes)
            den = den + segment_sum(w, ed, n_nodes)
        den = torch.clamp(den, min=1e-9)
        numh = num.reshape(n_nodes, S, H, C // H)
        return (numh / den[:, None, :, None].to(dt)).reshape(n_nodes, S, C)

    def layer(X, i):
        p = layer_params(params["layers"], i)
        agg = aggregate(p, X)
        X = X + _per_l_linear(p["w_upd"], agg, L)

        # invariant-gated equivariant FFN
        inv_n = X[:, 0, :]
        gates = torch.sigmoid(
            mlp_apply(p["gate_mlp"], inv_n).to(torch.float32)
        ).reshape(n_nodes, L + 1, C).to(dt)
        ffn = []
        for s, e, l in l_slices(L):
            if l == 0:
                ffn.append((mlp_apply(p["ffn0"], inv_n)
                            * gates[:, 0, :])[:, None, :])
            else:
                ffn.append(X[:, s:e, :] * gates[:, l:l + 1, :])
        return X + torch.cat(ffn, dim=1).to(X.dtype)

    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        X = (checkpoint(layer, X, i, use_reentrant=False) if remat
             else layer(X, i))

    inv = X[:, 0, :].to(torch.float32)
    return inv, mlp_apply(params["out"], inv)


def loss_edges(params, cfg: EquiformerConfig, node_feats, pos, edge_src,
               edge_dst, targets, n_nodes: int):
    _, out = forward_edges(params, cfg, node_feats, pos, edge_src, edge_dst,
                           n_nodes)
    return torch.mean(torch.square(out - targets))
