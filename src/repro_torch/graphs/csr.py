"""Fixed-shape graph container over torch tensors.

The counterpart of ``repro.graphs.csr``: the edge list sorted two ways
(by src = CSR order, by dst = CSC order) plus offset arrays.  The numpy
preprocessing is the reference's line for line, so the same ``seed``
gives the same arrays; only the final containers are torch tensors.
IMM's reverse BFS traverses *in*-edges (the CSC view).

Graphs are built on the host (``device="cpu"``); an engine moves the
tensors it needs to its own device with `Graph.to`.  The host tables of
the coin models (`wc_edge_probs`, `edge_arrays`, `dense_ic_matrix`) are
numpy, as in the reference, and bitwise its values.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Graph:
    n: int
    m: int
    # CSR (sorted by src): out-edges
    src_offsets: torch.Tensor  # (n+1,) int32
    out_dst: torch.Tensor      # (m,) int32 — dst of each out-edge
    # CSC (sorted by dst): in-edges
    dst_offsets: torch.Tensor  # (n+1,) int32
    in_src: torch.Tensor       # (m,) int32 — src of each in-edge
    in_prob: torch.Tensor      # (m,) float32 — IC prob, CSC order
    in_lt_cum: torch.Tensor    # (m,) float32 — LT cumulative weight
    in_lt_total: torch.Tensor  # (n,) float32 — per-node total LT weight
    # edge view (CSC order) for the vectorized IC steps
    edge_src: torch.Tensor     # (m,) int32 (== in_src)
    edge_dst: torch.Tensor     # (m,) int32

    @property
    def device(self) -> torch.device:
        return self.in_prob.device

    def to(self, device) -> "Graph":
        """The same graph with every tensor on ``device``."""
        device = torch.device(device)
        if device == self.device:
            return self
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)


def _offsets_from_sorted(keys: np.ndarray, n: int) -> np.ndarray:
    counts = np.bincount(keys, minlength=n)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def wc_edge_probs(dst, n: int) -> np.ndarray:
    """Weighted-cascade probabilities ``p(u->v) = 1/indeg(v)`` (float64)
    for edges with destinations ``dst``; zero in-degree is clamped to 1."""
    dst = _host(dst)
    indeg = np.bincount(dst, minlength=n).astype(np.float64)
    return 1.0 / np.maximum(indeg[dst], 1.0)


def build_graph(src, dst, n: int, *, ic_prob=None, seed: int = 0,
                weighted_ic: str = "uniform", lt_weight=None,
                device="cpu") -> Graph:
    """Build a Graph from numpy edge arrays.

    ``ic_prob``: explicit per-edge IC probabilities (aligned with
    ``(src, dst)``), or None → generated: ``"uniform"`` U(0,1), or
    ``"wc"`` (weighted cascade, 1/in-degree).  ``lt_weight``: explicit
    per-edge LT weights taken verbatim (callers keep per-dst sums <= 1;
    the streaming delta path rebuilds a mutated graph with them so every
    untouched dst keeps a bit-identical LT segment), or None → raw U(0,1)
    normalized per dst to a total drawn from U(0.3, 1).
    """
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    m = src.shape[0]
    rng = np.random.default_rng(seed)

    if ic_prob is None:
        if weighted_ic == "wc":
            ic_prob = wc_edge_probs(dst, n)
        else:
            ic_prob = rng.uniform(0.0, 1.0, size=m)
    ic_prob = np.asarray(ic_prob, dtype=np.float32)

    order_src = np.argsort(src, kind="stable")
    src_offsets = _offsets_from_sorted(src[order_src], n)
    out_dst = dst[order_src]

    order_dst = np.argsort(dst, kind="stable")
    dst_sorted = dst[order_dst]
    dst_offsets = _offsets_from_sorted(dst_sorted, n)
    in_src = src[order_dst]
    in_prob = ic_prob[order_dst]

    if lt_weight is None:
        raw = rng.uniform(0.0, 1.0, size=m).astype(np.float64)
        indeg = (dst_offsets[1:] - dst_offsets[:-1]).astype(np.int64)
        seg_sum = np.zeros(n, dtype=np.float64)
        np.add.at(seg_sum, dst_sorted, raw)
        total0 = rng.uniform(0.3, 1.0, size=n)
        total0 = np.where(indeg > 0, total0, 0.0)
        scale = np.where(seg_sum > 0, total0 / np.maximum(seg_sum, 1e-30),
                         0.0)
        w = raw * scale[dst_sorted]
    else:
        w = np.asarray(lt_weight, dtype=np.float64)[order_dst]
    cum = np.cumsum(w)
    seg_start_cum = np.concatenate([[0.0], cum])[dst_offsets[:-1]]
    lt_cum = cum - seg_start_cum[dst_sorted] if m else np.zeros(0)
    lt_total = np.zeros(n, dtype=np.float64)
    np.add.at(lt_total, dst_sorted, w)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    return Graph(
        n=n,
        m=m,
        src_offsets=t(src_offsets, np.int32),
        out_dst=t(out_dst, np.int32),
        dst_offsets=t(dst_offsets, np.int32),
        in_src=t(in_src, np.int32),
        in_prob=t(in_prob, np.float32),
        in_lt_cum=t(lt_cum, np.float32),
        in_lt_total=t(lt_total, np.float32),
        edge_src=t(in_src, np.int32),
        edge_dst=t(dst_sorted, np.int32),
    )


def edge_arrays(g: Graph):
    """Host ``(src, dst, ic_prob, lt_weight)`` arrays in CSC order.

    The LT weight of an edge is recovered from the within-segment
    cumulative sums, ``w[e] = lt_cum[e] - lt_cum[e-1]`` inside each dst
    segment, as exact float64 differences of the float32 sums: the GT
    model's marginals, bitwise the reference's.  A rebuild through
    ``build_graph(lt_weight=w)`` reproduces ``in_lt_cum`` bit for bit;
    ``in_lt_total`` may move by one float32 ulp on the first round trip
    and is idempotent after it (why `repro_torch.stream` canonicalizes a
    graph before streaming from it).
    """
    src = _host(g.in_src)
    dst = _host(g.edge_dst)
    prob = _host(g.in_prob)
    lt_cum = _host(g.in_lt_cum).astype(np.float64)
    dst_offsets = _host(g.dst_offsets)
    w = lt_cum.copy()
    seg_starts = dst_offsets[:-1][dst_offsets[:-1] < g.m]
    interior = np.ones(g.m, bool)
    interior[seg_starts] = False
    w[interior] = lt_cum[interior] - lt_cum[np.flatnonzero(interior) - 1]
    return src, dst, prob, w


def dense_ic_matrix(g: Graph, probs=None) -> np.ndarray:
    """Dense ``(n, n)`` float32 matrix with ``P[u, v]`` the activation
    probability of edge ``u -> v``; ``probs`` (CSC order) overrides the
    graph's IC probabilities.  Only for small n (the dense backends)."""
    P = np.zeros((g.n, g.n), dtype=np.float32)
    P[_host(g.in_src), _host(g.edge_dst)] = np.asarray(
        _host(g.in_prob if probs is None else probs), dtype=np.float32)
    return P
