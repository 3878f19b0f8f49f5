"""The R-MAT, Erdos-Renyi, star and path generators (numpy) of
``repro.graphs.generators``:
the same ``seed`` gives the same edges and weights."""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import Graph, build_graph


def rmat_graph(n: int, m: int, *, seed: int = 0, a=0.57, b=0.19, c=0.19,
               directed: bool = True, **kw) -> Graph:
    """Recursive-matrix (Kronecker) generator, R-MAT parameters a,b,c,d."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n, 2))))
    d = 1.0 - a - b - c
    probs = np.array([a, b, c, d])
    quad = rng.choice(4, size=(m, scale), p=probs)
    row_bits = (quad == 2) | (quad == 3)
    col_bits = (quad == 1) | (quad == 3)
    weights = (1 << np.arange(scale - 1, -1, -1)).astype(np.int64)
    src = (row_bits @ weights) % n
    dst = (col_bits @ weights) % n
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if not directed:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    eid = src.astype(np.int64) * n + dst.astype(np.int64)
    _, uniq = np.unique(eid, return_index=True)
    src, dst = src[uniq], dst[uniq]
    return build_graph(src, dst, n, seed=seed, **kw)


def erdos_graph(n: int, m: int, *, seed: int = 0, **kw) -> Graph:
    """Uniform random directed edges (self loops dropped, deduplicated)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=2 * m)
    dst = rng.integers(0, n, size=2 * m)
    keep = src != dst
    src, dst = src[keep][:m], dst[keep][:m]
    eid = src.astype(np.int64) * n + dst.astype(np.int64)
    _, uniq = np.unique(eid, return_index=True)
    return build_graph(src[uniq], dst[uniq], n, seed=seed, **kw)


def star_graph(n: int, *, p: float = 0.5, seed: int = 0) -> Graph:
    """Hub 0 -> spokes 1..n-1, every edge with IC probability ``p``
    (closed-form tests)."""
    src = np.zeros(n - 1, dtype=np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    prob = np.full(n - 1, p, dtype=np.float32)
    return build_graph(src, dst, n, ic_prob=prob, seed=seed)


def path_graph(n: int, *, p: float = 1.0, seed: int = 0) -> Graph:
    """0 -> 1 -> ... -> n-1 with a fixed edge probability (closed-form
    tests)."""
    src = np.arange(0, n - 1, dtype=np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    prob = np.full(n - 1, p, dtype=np.float32)
    return build_graph(src, dst, n, ic_prob=prob, seed=seed)
