"""Batched RRR-set sampling (Generate_RRRsets, paper Alg. 3): the IC model
on the ``sparse`` traversal backend, positional coins
(``repro.core.sampler``: ``_setup``, ``_sparse_loop``, ``_bind_sparse``).

Each BFS step draws one coin per (row, edge) by array position —
``uniform(sub, (B, m)) < edge_prob``, the `ic_sparse_hits` kernel on the
card — and expands the reverse frontier over the CSC edge list: an edge
``u -> v`` is live when ``v`` is in the frontier, its coin hits and
``u`` is unvisited; live edges scatter-or into ``u``.  The key chain
(one split per batch, ``_setup``'s split plus randint, one split per
step) and every coin are jax's, so the sampled sets are bitwise the
JAX package's for the same key.

The other models (WC, GT, LT), backends (dense, pallas, walk) and the
identity-keyed ``+stable`` coins are not ported yet; naming one raises
`NotImplementedError` with its ROADMAP item.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.graphs.csr import Graph
from repro_torch.kernels import ops as kops

# what each unported sampler axis waits for (ROADMAP queue A)
_MODELS = {"IC": "coins", "WC": "coins", "GT": "coins", "LT": "walk"}
_MISSING = {
    "dense": "the dense log-semiring backend (ROADMAP A1)",
    "pallas": "the pallas backend with the ic_frontier_step kernel "
              "(ROADMAP A1, kernel B1)",
    "walk": "the LT walk backend (ROADMAP A4)",
    "WC": "the WC/GT coin models (ROADMAP A1)",
    "GT": "the WC/GT coin models (ROADMAP A1)",
    "stable": "identity-keyed +stable coins (ROADMAP A1)",
}


def composed_name(model: str, backend: str, stable: bool = False) -> str:
    """Canonical registry spelling ``"<model>/<backend>[+stable]"``."""
    return f"{model}/{backend}" + ("+stable" if stable else "")


def default_sampler_name(graph: Graph, cfg) -> str:
    """Resolve ``cfg`` to a composed name as the reference does: coin
    models take the dense backend up to ``cfg.dense_sampler_max_n`` and
    the sparse one above it, walk models the walk backend;
    ``cfg.backend`` and ``cfg.stable`` override."""
    family = _MODELS.get(cfg.model)
    if family is None:
        raise ValueError(f"unknown diffusion model {cfg.model!r}; "
                         f"known: {sorted(_MODELS)}")
    backend = getattr(cfg, "backend", None)
    if backend is None:
        backend = ("walk" if family == "walk" else
                   "dense" if graph.n <= cfg.dense_sampler_max_n else "sparse")
    return composed_name(cfg.model, backend, bool(getattr(cfg, "stable",
                                                          False)))


def _setup(key, batch: int, n_nodes: int, device):
    """``(kstep, roots, visited)``: the (kroot, kstep) split, the batch
    roots and the initial visited rows (a ``(B, n)`` bool view of a
    buffer whose rows are padded to `kops.padded_width`, so the commit
    kernel reads them with 16-byte loads)."""
    kroot, kstep = prng.split(key)
    roots = prng.randint(kroot, (batch,), 0, n_nodes, device=device)
    buf = torch.zeros((batch, kops.padded_width(n_nodes)), dtype=torch.bool,
                      device=device)
    visited = buf[:, :n_nodes]
    visited[torch.arange(batch, device=device), roots.long()] = True
    return kstep, roots, visited


def _sparse_loop(key, edge_src, edge_dst, edge_prob, *, n_nodes: int,
                 batch: int, max_steps: int = 0):
    """CSC edge-list frontier expansion with positional coins.

    ``edge_src``/``edge_dst`` are int64 index tensors on the sampling
    device.  Returns ``(visited (B, n) uint8, counter (n,) int32,
    roots (B,) int32)``; ``visited`` is a row-padded view.
    """
    m = edge_src.shape[0]
    max_steps = max_steps or n_nodes
    k, roots, visited = _setup(key, batch, n_nodes, edge_prob.device)
    frontier = visited.clone()
    step = 0
    while step < max_steps and bool(frontier.any()):
        k, sub = prng.split(k)
        hit = kops.ic_sparse_hits(sub, edge_prob, batch)
        # reverse traversal: edge u->v is usable when v is in the frontier
        live = frontier[:, edge_dst] & hit & ~visited[:, edge_src]
        # scatter-or into src from the live (row, edge) pairs only — an
        # index expanded to (B, m) int64 would take 8 bytes per coin
        flat = live.view(-1).nonzero().squeeze(1)
        rows = torch.div(flat, m, rounding_mode="floor")
        new = torch.zeros((batch, n_nodes), dtype=torch.bool,
                          device=visited.device)
        new.view(-1)[rows * n_nodes + edge_src[flat - rows * m]] = True
        new &= ~visited
        visited |= new
        frontier = new
        step += 1
    counter = visited.sum(dim=0, dtype=torch.int32)
    return visited.view(torch.uint8), counter, roots


def _bind_sparse(graph: Graph, cfg):
    src = graph.edge_src.long()
    dst = graph.edge_dst.long()
    prob = graph.in_prob.to(torch.float32).contiguous()

    def sample(key):
        return _sparse_loop(key, src, dst, prob, n_nodes=graph.n,
                            batch=cfg.batch)

    return sample


def _not_ported(name: str) -> NotImplementedError:
    model, _, rest = name.partition("/")
    backend, plus, _ = rest.partition("+")
    missing = [_MISSING[a] for a in (model, backend) if a in _MISSING]
    if plus:
        missing.append(_MISSING["stable"])
    what = "; ".join(missing) or "a sampler registry entry"
    return NotImplementedError(
        f"sampler {name!r} is not ported yet: it needs {what}. "
        f"Ported: 'IC/sparse'")


def make_sampler(model, backend=None, *, stable: bool = False):
    """Compose a sampler factory ``factory(graph, cfg) -> sample(key)``;
    only ``("IC", "sparse")`` positional is ported."""
    name = composed_name(model, backend or "dense", stable)
    if name != "IC/sparse":
        raise _not_ported(name)
    return _bind_sparse


def get_sampler(name: str):
    """The factory registered under ``name``."""
    if name == "IC/sparse":
        return _bind_sparse
    model, sep, _ = name.partition("/")
    if not sep or model not in _MODELS:
        raise ValueError(f"unknown sampler {name!r}")
    raise _not_ported(name)

