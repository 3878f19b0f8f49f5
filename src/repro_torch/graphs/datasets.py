"""SNAP dataset registry (paper Table I) with hermetic R-MAT stand-ins of
the same |V|, |E| and directedness (``repro.graphs.datasets``)."""
from __future__ import annotations

from repro_torch.graphs.generators import rmat_graph

# name: (nodes, edges, directed)  — paper Table I
SNAP_STATS = {
    "com-Amazon":  (334_863, 925_872, False),
    "com-YouTube": (1_134_890, 2_987_624, False),
    "com-DBLP":    (317_080, 1_049_866, False),
    "com-LJ":      (3_997_962, 34_681_189, False),
    "soc-Pokec":   (1_632_803, 30_622_564, True),
    "as-Skitter":  (1_696_415, 11_095_298, False),
    "web-Google":  (875_713, 5_105_039, True),
    "Twitter7":    (41_652_230, 1_468_365_182, True),
}


def synthetic_snap(name: str, *, seed: int = 0, **kw):
    n, m, directed = SNAP_STATS[name]
    return rmat_graph(n, m, seed=seed, directed=directed, **kw)


def scaled_snap(name: str, scale: float, *, seed: int = 0, **kw):
    """Density-preserving shrink."""
    n, m, directed = SNAP_STATS[name]
    ns = max(int(n * scale), 64)
    ms = max(int(m * scale), 4 * ns)
    return rmat_graph(ns, ms, seed=seed, directed=directed, **kw)
