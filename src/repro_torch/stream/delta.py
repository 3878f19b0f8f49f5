"""GraphDelta — batched dynamic-graph mutations (``repro.stream.delta``).

A delta is an ordered batch of edge operations applied atomically
between serving epochs.  Vertices are a fixed universe (``n`` never
changes); edges are identified by their ``(src, dst)`` pair.

  * ``insert``   — the edge must not exist; it gets the given IC
    probability and the LT weight ``p * (1 - total(dst))``, which keeps
    every per-dst total below 1 without touching another edge's weight.
  * ``delete``   — the edge must exist; it is removed.
  * ``reweight`` — the edge must exist; its IC probability is replaced
    (its LT weight is kept).
  * Later operations in one delta see the effects of earlier ones.

Untouched dst segments keep bit-identical LT cumulative weights and IC
probabilities across `GraphDelta.apply` (see
`repro_torch.graphs.csr.edge_arrays`), which is what lets
`repro_torch.stream.invalidate` bound staleness to the rows whose
traversal touched a mutated edge's destination.  All of it is host
numpy, as in the reference, so the same delta on the same graph gives
bitwise the reference's arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.graphs.csr import Graph, build_graph, edge_arrays

OP_INSERT = 0
OP_DELETE = 1
OP_REWEIGHT = 2
_OP_NAMES = {OP_INSERT: "insert", OP_DELETE: "delete",
             OP_REWEIGHT: "reweight"}


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """An ordered batch of edge mutations: ``src``/``dst`` ``(E,) int32``
    endpoints, ``prob`` ``(E,) float32`` IC probabilities (ignored for
    deletes), ``op`` ``(E,) int8`` opcodes (`OP_INSERT` / `OP_DELETE` /
    `OP_REWEIGHT`)."""
    src: np.ndarray
    dst: np.ndarray
    prob: np.ndarray
    op: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "src", np.asarray(self.src, np.int32))
        object.__setattr__(self, "dst", np.asarray(self.dst, np.int32))
        object.__setattr__(self, "prob", np.asarray(self.prob, np.float32))
        object.__setattr__(self, "op", np.asarray(self.op, np.int8))
        e = self.src.shape[0]
        if not (self.dst.shape[0] == self.prob.shape[0]
                == self.op.shape[0] == e):
            raise ValueError("GraphDelta arrays must share one length")
        if e and not np.isin(self.op, list(_OP_NAMES)).all():
            raise ValueError(f"unknown opcode in {np.unique(self.op)}")
        needs_p = self.op != OP_DELETE
        if needs_p.any():
            p = self.prob[needs_p]
            if not (np.isfinite(p).all() and (p >= 0).all()
                    and (p <= 1).all()):
                raise ValueError(
                    "insert/reweight probabilities must lie in [0, 1]")

    # -------------------------------------------------------- construction

    @classmethod
    def inserts(cls, src, dst, prob) -> "GraphDelta":
        src = np.asarray(src)
        return cls(src, dst, prob, np.full(src.shape[0], OP_INSERT))

    @classmethod
    def deletes(cls, src, dst) -> "GraphDelta":
        src = np.asarray(src)
        return cls(src, dst, np.zeros(src.shape[0]),
                   np.full(src.shape[0], OP_DELETE))

    @classmethod
    def reweights(cls, src, dst, prob) -> "GraphDelta":
        src = np.asarray(src)
        return cls(src, dst, prob, np.full(src.shape[0], OP_REWEIGHT))

    @classmethod
    def concat(cls, deltas) -> "GraphDelta":
        """One delta applying ``deltas`` in order."""
        return cls(np.concatenate([d.src for d in deltas]),
                   np.concatenate([d.dst for d in deltas]),
                   np.concatenate([d.prob for d in deltas]),
                   np.concatenate([d.op for d in deltas]))

    def __len__(self) -> int:
        return int(self.src.shape[0])

    # --------------------------------------------------------- staleness

    def touched_vertices(self) -> np.ndarray:
        """The destinations of the mutated edges: RRR traversal is
        reverse, so an edge ``u -> v`` is consulted only once ``v`` is in
        the set, and a row that never visited a mutated ``v`` re-samples
        identically under a delta-stable sampler."""
        return np.unique(self.dst).astype(np.int32)

    # ------------------------------------------------------------- apply

    def apply(self, graph: Graph) -> Graph:
        """Rebuild ``graph`` (on the host) with this delta applied.
        Inserting an existing edge, or deleting or reweighting a missing
        one, raises ``ValueError`` naming the entry."""
        n = graph.n
        if len(self) and ((self.src < 0).any() or (self.src >= n).any()
                          or (self.dst < 0).any() or (self.dst >= n).any()):
            raise ValueError(f"delta endpoints out of range for n={n}")
        src, dst, prob, w = edge_arrays(graph)
        prob = prob.astype(np.float32).copy()
        w = w.copy()
        alive = np.ones(src.shape[0], bool)
        keys = src.astype(np.int64) * n + dst
        table = {int(k): i for i, k in enumerate(keys)}
        totals = np.zeros(n, np.float64)
        np.add.at(totals, dst, w)
        app_src, app_dst, app_prob, app_w = [], [], [], []
        app_table: dict[int, int] = {}

        for i in range(len(self)):
            u, v, p, o = (int(self.src[i]), int(self.dst[i]),
                          float(self.prob[i]), int(self.op[i]))
            k = u * n + v
            pos = table.get(k)
            exists_orig = pos is not None and alive[pos]
            jpos = app_table.get(k)
            exists_new = jpos is not None
            if o == OP_INSERT:
                if exists_orig or exists_new:
                    raise ValueError(
                        f"delta[{i}]: insert of existing edge {u}->{v}")
                wi = p * max(0.0, 1.0 - float(totals[v]))
                app_table[k] = len(app_src)
                app_src.append(u)
                app_dst.append(v)
                app_prob.append(p)
                app_w.append(wi)
                totals[v] += wi
            elif o == OP_DELETE:
                if exists_orig:
                    alive[pos] = False
                    totals[v] -= w[pos]
                elif exists_new:
                    totals[v] -= app_w[jpos]
                    del app_table[k]
                    app_w[jpos] = 0.0
                    app_prob[jpos] = -1.0     # tombstone, filtered below
                else:
                    raise ValueError(
                        f"delta[{i}]: delete of missing edge {u}->{v}")
            else:  # OP_REWEIGHT
                if exists_orig:
                    prob[pos] = np.float32(p)
                elif exists_new:
                    app_prob[jpos] = p
                else:
                    raise ValueError(
                        f"delta[{i}]: reweight of missing edge {u}->{v}")

        live_new = [j for j, p in enumerate(app_prob) if p >= 0.0]
        new_src = np.concatenate(
            [src[alive], np.asarray([app_src[j] for j in live_new],
                                    np.int32)])
        new_dst = np.concatenate(
            [dst[alive], np.asarray([app_dst[j] for j in live_new],
                                    np.int32)])
        new_prob = np.concatenate(
            [prob[alive], np.asarray([app_prob[j] for j in live_new],
                                     np.float32)])
        new_w = np.concatenate(
            [w[alive], np.asarray([app_w[j] for j in live_new],
                                  np.float64)])
        return build_graph(new_src, new_dst, n, ic_prob=new_prob,
                           lt_weight=new_w)

    def apply_dense(self, P) -> torch.Tensor:
        """Apply to a dense ``(n, n)`` IC matrix (``P[u, v] = p(u->v)``)
        out of place: deletes zero the entry, inserts and reweights set
        it (the last operation on an edge wins).  Existence is not
        checked here; `apply` is the strict path."""
        P = torch.as_tensor(P)
        if not len(self):
            return P
        final: dict[tuple[int, int], float] = {}
        for i in range(len(self)):
            u, v = int(self.src[i]), int(self.dst[i])
            final[(u, v)] = (0.0 if int(self.op[i]) == OP_DELETE
                             else float(self.prob[i]))
        uu = torch.as_tensor([k[0] for k in final], device=P.device)
        vv = torch.as_tensor([k[1] for k in final], device=P.device)
        pp = torch.as_tensor(np.asarray(list(final.values()), np.float32),
                             device=P.device)
        out = P.clone()
        out[uu, vv] = pp.to(P.dtype)
        return out


def canonicalize(graph: Graph) -> Graph:
    """Round-trip a graph through `edge_arrays`/`build_graph` once (on
    the host).  The result is delta-stable: every later rebuild (each
    `GraphDelta.apply`) reproduces untouched edges' IC probabilities, LT
    cumulative weights and LT totals bit for bit."""
    src, dst, prob, w = edge_arrays(graph)
    return build_graph(src, dst, graph.n, ic_prob=prob, lt_weight=w)


def random_delta(graph: Graph, rng, *, inserts: int = 0, deletes: int = 0,
                 reweights: int = 0,
                 max_dst_indeg: int | None = None) -> GraphDelta:
    """A valid random delta for ``graph``: deletes and reweights from
    distinct existing edges, inserts from absent pairs (rejection
    sampled), probabilities U(0, 1); the same draws from the same
    ``np.random.Generator`` as the reference.  ``max_dst_indeg`` limits
    the mutated destinations to vertices of at most that in-degree (the
    long-tail churn of evolving networks: a hub sits in most RRR sets,
    so mutating it stales most of the store)."""
    n = graph.n
    src, dst = (t.cpu().numpy() for t in (graph.in_src, graph.edge_dst))
    indeg = np.bincount(dst, minlength=n)
    if max_dst_indeg is not None:
        edge_pool = np.flatnonzero(indeg[dst] <= max_dst_indeg)
        vert_pool = np.flatnonzero(indeg < max_dst_indeg)
        if edge_pool.size < deletes + reweights or not vert_pool.size:
            raise ValueError(
                f"max_dst_indeg={max_dst_indeg} leaves too few candidate "
                f"edges/vertices")
    else:
        edge_pool = np.arange(src.shape[0])
        vert_pool = np.arange(n)
    existing = set((src.astype(np.int64) * n + dst).tolist())
    parts = []
    if deletes or reweights:
        take = edge_pool[rng.choice(edge_pool.shape[0],
                                    size=deletes + reweights,
                                    replace=False)]
        if deletes:
            d = take[:deletes]
            parts.append(GraphDelta.deletes(src[d], dst[d]))
        if reweights:
            r = take[deletes:]
            parts.append(GraphDelta.reweights(
                src[r], dst[r], rng.uniform(0.0, 1.0, size=reweights)))
    if inserts:
        pairs = []
        seen = set(existing)
        while len(pairs) < inserts:
            u = int(rng.integers(n))
            v = int(vert_pool[rng.integers(vert_pool.shape[0])])
            k = u * n + v
            if u == v or k in seen:
                continue
            seen.add(k)
            pairs.append((u, v))
        uu = np.asarray([p[0] for p in pairs], np.int32)
        vv = np.asarray([p[1] for p in pairs], np.int32)
        parts.append(GraphDelta.inserts(
            uu, vv, rng.uniform(0.0, 1.0, size=inserts)))
    if not parts:
        raise ValueError("random_delta needs at least one operation")
    return GraphDelta.concat(parts)
