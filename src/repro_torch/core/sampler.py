"""Batched RRR-set samplers (Generate_RRRsets, paper Alg. 3), composed from
a diffusion model and a traversal backend (``repro.core.sampler``).

  * **DiffusionModel** — what an edge does with randomness.  `CoinModel`
    ("coins" family): each in-edge ``u -> v`` fires an independent coin
    with a model marginal when ``v`` first enters the reverse frontier;
    built-ins ``IC`` (the graph's edge probabilities), ``WC`` (weighted
    cascade, ``1/indeg(dst)``) and ``GT`` (the LT triggering weights as
    independent marginals).  `WalkModel` ("walk" family): built-in ``LT``.
  * **TraversalBackend** — how the traversal runs:

      - ``dense``: the log-semiring step ``rand < -expm1(frontier @
        logq) & ~visited`` with ``frontier @ logq`` a library product
        (``torch.matmul``, TF32 off);
      - ``pallas``: the same step through the hand-written
        ``ic_frontier_step`` kernel (`repro_torch.kernels.ops`), which
        sums in ascending v — bitwise equal to itself on the card and on
        the host; ``dense`` differs from it only where a coin sits within
        a few ulps of its threshold (a near-tie, `repro_torch.core.ties`);
      - ``sparse``: per-edge coins and a scatter over the CSC edge list
        (positional coins through the ``ic_sparse_hits`` kernel); exact,
        bitwise the reference for every coin model;
      - ``walk``: the LT random walk (`_walk_loop`), one uniform a row a
        step (positional draws through the ``uniform_draw`` kernel) and
        the reference's unguarded binary search over the dst's
        cumulative weights; bitwise the reference's.

  * **stable** — positional coins (``uniform(key, shape)``) or
    identity-keyed counter-mode coins (a hash of step key, row position
    and vertex or edge id) that re-generate any subset of a batch's rows
    through ``positions``.

The full model x backend x stable matrix is registered under
``"<model>/<backend>[+stable]"`` with the reference's legacy aliases.
Roots, coins, the WC/GT marginals and every sparse result are bitwise the
reference's for the same key; dense and pallas activations equal the
reference's up to classified near-ties (the reference sums in XLA's
order with f32 ``expm1``).

The sparse backend also emits a batch natively as C4 index lists
(``emit_l``, tagged ``supports_index_emit``) for an `IndexStore`.

Under a mesh ``placement`` (a meshed store's `BatchPlacement`) a bound
sampler samples each theta shard's row block on that shard's device and
returns the batch as one ``(visited, counter, roots)`` block per shard:
the roots come from one draw over the whole batch, sliced, and the
coins of a block from its rows' counters (``ic_sparse_hits`` and
``uniform_draw`` take a first row; stable coins key on the rows' global
positions), so every block is bitwise its rows of the unplaced batch.
Rows never interact and an empty frontier never changes a row, so each
block ends its BFS at its own step.  A stable sampler re-samples a row
subset (``positions``) of a placed batch unplaced, on the first shard's
device, as the reference does; the rows go to the store's
``replace_rows``, which sends each tile its columns.

On a 2D placement (a meshed store with a vertex axis) the dense and
pallas backends column-block the BFS over the store's vertex tiles, as
the reference's ``_dense_loop`` does under ``_shard_cols``: tile ``(t,
v)`` holds logq's columns of vertex block ``v`` (only its live columns:
the pad columns of a balanced block are never sampled, so they never
activate) and, for pallas, their column form, built once per bound
sampler per tile device.  Each step every tile computes its own columns
of ``new`` from the frontier gathered over the vertex axis
(`repro_torch.mesh.all_gather_cols`).  With ``overlap`` (``cfg.overlap``)
step t+1's gather runs on a side CUDA stream as soon as step t's
``new`` exists, ordered by events, while the next step's coins are
drawn: a pure scheduling change.  Positional coins are the columns of
the shard's row block of the one ``(B, n)`` draw: the row block is drawn
once on the shard's device (``uniform_draw`` takes one flat start, and a
column block is not contiguous in the flat index) and each tile takes
its column slice, so no kernel needs a strided form; stable coins key on
global vertex ids.  The pallas kernel sums each column's nonzeros in
ascending v whatever block the column is in, so every row is bitwise
the unblocked port's, overlap on or off; the dense backend's library
product may round a blocked column otherwise (near-ties,
`repro_torch.core.ties`).  ``pallas_interpret`` is inert (no Pallas).
"""
from __future__ import annotations

import dataclasses
import inspect
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch import mesh as mesh_ops
from repro_torch import obs, prng
from repro_torch.core.adaptive import bitmap_to_indices
from repro_torch.core.store import next_pow2
from repro_torch.graphs.csr import (
    Graph, dense_ic_matrix, edge_arrays, wc_edge_probs,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ic_frontier import activation, column_form

_LOGQ_CLAMP = -30.0  # exp(-30) ~ 1e-13: treat p=1 edges as prob 1-1e-13


def _placed(bind_block, graph: Graph, placement, batch: int, stable: bool):
    """A bound sampler under a mesh ``placement``: ``bind_block(g)`` binds
    the unplaced sampler on ``g`` (the graph on one shard's device, bound
    once a device), and each call samples every theta shard's row block
    there (``rows=(lo, hi)``).  Returns ``(visited, counter, roots)`` as
    tuples of one block per shard."""
    bound = {}
    for dev in placement.devices:
        if dev not in bound:
            bound[dev] = bind_block(graph.to(dev))

    def run(key, **kw):
        return _per_block(placement, batch,
                          lambda dev, rows: bound[dev](key, rows=rows, **kw))
    return _with_subsets(run, lambda: bound[placement.devices[0]], stable)


def _with_subsets(run, home_sampler, stable: bool):
    """The placed sampler ``run``, and for a ``stable`` one its row
    subsets (``positions``), sampled unplaced by ``home_sampler()``, the
    unplaced sampler on the first shard's device."""
    if not stable:
        return run

    def sample(key, positions=None, **kw):
        if positions is not None:
            return home_sampler()(key, positions=positions, **kw)
        return run(key, **kw)
    return sample


def _per_block(placement, batch: int, run):
    """``run(device, (lo, hi))`` for each theta shard's row block of a
    ``batch``-row batch under ``placement``, regrouped as ``(visited,
    counter, roots)`` tuples of one block per shard."""
    out = [run(dev, (lo, hi)) for dev, lo, hi in placement.blocks(batch)]
    return tuple(tuple(o[i] for o in out) for i in range(3))


# ---------------------------------------------------------------- models ----

@dataclasses.dataclass(frozen=True)
class CoinModel:
    """Edge-factored ("coins" family) diffusion semantics:
    ``edge_probs(graph) -> (m,)`` float32 marginals in CSC order (a torch
    tensor or a numpy array)."""
    name: str
    edge_probs: Callable[[Graph], object]
    family: str = dataclasses.field(default="coins", init=False)


@dataclasses.dataclass(frozen=True)
class WalkModel:
    """Pick-at-most-one ("walk" family) diffusion semantics:
    ``walk_tables(graph) -> (dst_offsets, in_src, cum, total)``."""
    name: str
    walk_tables: Callable[[Graph], tuple]
    family: str = dataclasses.field(default="walk", init=False)


def _wc_probs(graph: Graph) -> torch.Tensor:
    """Weighted cascade: p(u -> v) = 1 / indeg(v), CSC order."""
    return torch.from_numpy(
        wc_edge_probs(graph.edge_dst, graph.n).astype(np.float32))


def _gt_probs(graph: Graph) -> torch.Tensor:
    """Generalized triggering: the LT triggering weights as independent
    per-edge marginals (CSC order; per-dst sums are <= 1)."""
    _, _, _, w = edge_arrays(graph)
    return torch.from_numpy(np.clip(w, 0.0, 1.0).astype(np.float32))


IC = CoinModel("IC", lambda g: g.in_prob)
WC = CoinModel("WC", _wc_probs)
GT = CoinModel("GT", _gt_probs)
LT = WalkModel("LT", lambda g: (g.dst_offsets, g.in_src, g.in_lt_cum,
                                g.in_lt_total))

_MODEL_REGISTRY: dict = {}


def register_model(model) -> None:
    """Register a `CoinModel`/`WalkModel` under its name (overwrites
    silently so experiments can shadow the built-ins)."""
    _MODEL_REGISTRY[model.name] = model


def get_model(name: str):
    try:
        return _MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown diffusion model {name!r}; registered: "
            f"{sorted(_MODEL_REGISTRY)}") from None


def registered_models():
    return sorted(_MODEL_REGISTRY)


for _m in (IC, WC, GT, LT):
    register_model(_m)


def _edge_probs(model, graph: Graph) -> torch.Tensor:
    """The model's marginals as a contiguous float32 tensor on the
    graph's device."""
    return torch.as_tensor(model.edge_probs(graph), dtype=torch.float32,
                           device=graph.device).contiguous()


def logq_from_probs(graph: Graph, probs) -> torch.Tensor:
    """Dense ``(n, n)`` log(1-p) matrix in reverse-traversal orientation,
    ``logq[v, u] = log(1 - p_{u->v})``, on the graph's device.  Computed
    on the host in float64, rounded once to float32 and clamped at
    ``_LOGQ_CLAMP``, so every device builds the same bits (within one ulp
    of the reference's f32 ``log1p`` table)."""
    P = dense_ic_matrix(graph, probs)
    with np.errstate(divide="ignore"):
        L = np.log1p(-np.ascontiguousarray(P.T).astype(np.float64))
    L = np.maximum(L.astype(np.float32), np.float32(_LOGQ_CLAMP))
    return torch.from_numpy(L).to(graph.device)


def make_logq(graph: Graph) -> torch.Tensor:
    """`logq_from_probs` for the IC model."""
    return logq_from_probs(graph, graph.in_prob)


# ----------------------------------------------- the stable-coin machinery ----
#
# Identity-keyed coins: a stateless counter-mode hash of (step key, row
# position, vertex or edge id), so a row re-generates alone (``positions``)
# and an edge keeps its coin when others are inserted or deleted.  uint32
# arithmetic runs in int32, whose add, multiply and xor wrap modulo 2**32
# exactly as uint32 does; right shifts are masked to act as logical ones.

def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    return (x >> s) & ((1 << (32 - s)) - 1)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix-style avalanche on uint32 bits held in int32."""
    x = (x ^ _shr(x, 16)) * prng.u32_to_i32(0x7FEB352D)
    x = (x ^ _shr(x, 15)) * prng.u32_to_i32(0x846CA68B)
    return x ^ _shr(x, 16)


def _u01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 hash bits -> float32 uniform in [0, 1)."""
    return _shr(bits, 8).to(torch.float32) * (1.0 / (1 << 24))


_GOLD = 0x9E3779B9   # 2**32 / phi — the classic Weyl increment


def _stable_uniform(sub, ids: torch.Tensor, bb: torch.Tensor,
                    rows=None) -> torch.Tensor:
    """``_u01(_mix32(_mix32(ids ^ k0) ^ bb ^ k1))``: the ``(K, len(ids))``
    stable draw of step key ``sub`` (``rows=(start, stop)`` selects a row
    block of ``bb``)."""
    k0, k1 = (prng.u32_to_i32(int(w)) for w in prng.as_key(sub))
    h = _mix32(ids ^ k0)[None, :]
    b = bb if rows is None else bb[rows[0]:rows[1]]
    return _u01(_mix32(h ^ b ^ k1))


def _setup(key, batch: int, n_nodes: int, device, positions=None,
           stable: bool = False, rows=None):
    """``(kstep, roots, visited, bb)``: the (kroot, kstep) split, the
    roots (of ``positions``, or of the row block ``rows=(lo, hi)``, when
    given), the initial visited rows — a ``(K, n)`` bool view of a
    buffer whose rows are padded to `kops.padded_width`, so the commit
    kernel reads them with 16-byte loads — and (stable only) the ``(K,
    1)`` per-row hash lanes ``position * _GOLD``.  The PRNG op sequence
    (one split plus one randint over the whole batch) is the same in
    every mode, as in the reference."""
    kroot, kstep = prng.split(key)
    roots = prng.randint(kroot, (batch,), 0, n_nodes, device=device)
    lo, hi = (0, batch) if rows is None else rows
    bb = None
    if positions is not None and rows is not None:
        raise ValueError("give positions or a row block, not both")
    if not stable:
        if positions is not None:
            raise ValueError(
                "positions-subset resampling needs stable=True "
                "(identity-keyed coins); positional samplers can only "
                "re-generate whole batches")
        roots = roots[lo:hi]
    else:
        pos = (torch.arange(lo, hi, device=device) if positions is None
               else torch.as_tensor(positions, device=device).long())
        roots = roots[pos]
        bb = ((pos * _GOLD) & prng.MASK32).to(torch.int32)[:, None]
    K = roots.shape[0]
    buf = torch.zeros((K, kops.padded_width(n_nodes)), dtype=torch.bool,
                      device=device)
    visited = buf[:, :n_nodes]
    visited[torch.arange(K, device=device), roots.long()] = True
    return kstep, roots, visited, bb


def _dense_coins(sub, batch: int, K: int, n: int, uids, bb, device,
                 row0: int = 0) -> torch.Tensor:
    """One BFS step's ``(K, n)`` float32 draw of the dense backends: rows
    ``[row0, row0 + K)`` of the batch's positional draw, or the stable
    draw of the rows' hash lanes ``bb``."""
    if bb is not None:
        return _stable_uniform(sub, uids, bb)
    return kops.uniform(sub, (batch, n), device=device, start=row0 * n,
                        count=K * n).view(K, n)


def dense_coins(key, step: int, *, batch: int, n_nodes: int,
                positions=None, stable: bool = False,
                device="cpu") -> torch.Tensor:
    """The draw of BFS step ``step`` (1-based) of the dense loop for batch
    key ``key``: the loop's key chain replayed without the traversal
    (near-tie classification rebuilds a step's inputs from it)."""
    k, _, _, bb = _setup(key, batch, n_nodes, device, positions, stable)
    for _ in range(step):
        k, sub = prng.split(k)
    uids = torch.arange(n_nodes, dtype=torch.int32, device=device)
    return _dense_coins(sub, batch, bb.shape[0] if stable else batch,
                        n_nodes, uids, bb, device)


def _frontier_count(frontier: torch.Tensor) -> int:
    """Members of the frontier (one host sync a BFS step; a walk's
    frontier is its active rows), also counted on
    ``sampler.frontier_cells`` / ``sampler.steps``."""
    return _note_cells(int(frontier.sum()))


def _note_cells(cells: int) -> int:
    if cells:
        obs.counter("sampler.steps").add(1)
        obs.counter("sampler.frontier_cells").add(cells)
    return cells


# -------------------------------------------------------- traversal loops ----

def _dense_loop(key, logq, positions=None, *, batch: int, max_steps: int = 0,
                stable: bool = False, kernel: bool = False, cols=None,
                rows=None):
    """Dense log-semiring frontier expansion (the ``dense`` backend, or
    with ``kernel=True`` the ``pallas`` backend: each step is one
    `kops.ic_frontier_step`, handed ``cols``, logq's `column_form`, when
    the caller built it once) on logq's device: `_dense_loop_tiled` with
    one tile holding every column.  ``rows=(lo, hi)`` samples just that
    row block of the batch.

    Returns ``(visited (K, n) uint8, counter (n,) int32, roots (K,))``,
    ``K = len(positions)`` or the batch; ``visited`` is a row-padded view.
    """
    n = logq.shape[0]
    return _dense_loop_tiled(key, [(logq.device, 0, n, logq, cols)],
                             positions, batch=batch, n=n, home=logq.device,
                             rows=rows, max_steps=max_steps, stable=stable,
                             kernel=kernel)


def _padded_bool(K: int, w: int, device) -> torch.Tensor:
    """A zeroed ``(K, w)`` bool view of a row-padded buffer."""
    return torch.zeros((K, kops.padded_width(w)), dtype=torch.bool,
                       device=device)[:, :w]


def _gather_cols(parts, home, K: int, n: int) -> torch.Tensor:
    """The tiles' column blocks as one ``(K, n)`` row-padded block on
    ``home``: a lone part already there is returned as it is."""
    if len(parts) == 1 and parts[0].device == home:
        return parts[0]
    return mesh_ops.all_gather_cols(parts, home, _padded_bool(K, n, home))


class _Gather:
    """The vertex-axis frontier exchange of a column-blocked BFS: the
    tiles' ``new`` blocks gathered into the ``(K, n)`` frontier on the
    shard's device.  With ``overlap`` on a card and more than one tile
    the gather runs on a side stream, after an event on each tile's
    stream, and the next step's users wait on its event; otherwise it
    runs in line."""

    def __init__(self, home, overlap: bool, n_tiles: int):
        self.home = home
        self.side = (torch.cuda.Stream(home) if overlap and n_tiles > 1
                     and home.type == "cuda" else None)
        self.done = None

    def __call__(self, parts, K: int, n: int) -> torch.Tensor:
        if self.side is None:
            return _gather_cols(parts, self.home, K, n)
        for p in parts:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(p.device))
            self.side.wait_event(ev)
            p.record_stream(self.side)
        with torch.cuda.stream(self.side):
            out = mesh_ops.all_gather_cols(
                parts, self.home, _padded_bool(K, n, self.home))
        self.done = torch.cuda.Event()
        self.done.record(self.side)
        return out

    def ready_on(self, frontier, device) -> torch.Tensor:
        """The gathered frontier for a tile on ``device`` (its stream made
        to wait for the gather first)."""
        if self.side is not None and self.done is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(self.done)
            frontier.record_stream(stream)
        return frontier.to(device, non_blocking=True)


def _dense_loop_tiled(key, tiles, positions=None, *, batch: int, n: int,
                      home, rows=None, max_steps: int = 0,
                      stable: bool = False, kernel: bool = False,
                      overlap: bool = False):
    """The dense/pallas BFS of the batch's rows (``positions``, or the row
    block ``rows=(lo, hi)``, or all of them), column-blocked over vertex
    tiles: ``tiles`` is a list over ``v`` of ``(device, c0, c1, logq
    block (n, c1 - c0), its column form or None)``.  Each tile keeps its
    columns of ``visited`` and computes its columns of ``new`` from the
    whole frontier (a library product on ``dense``, the kernel on
    ``pallas``); the frontier is gathered over the tiles each step
    (`_Gather`).  One key chain, roots and coins whatever the tiling:
    positional coins are the columns of the rows' one draw, stable ones
    key on global vertex ids.  Returns ``(visited (K, n) uint8, counter,
    roots)`` on ``home``."""
    if not kernel and torch.backends.cuda.matmul.allow_tf32 \
            and any(t[0].type == "cuda" for t in tiles):
        raise RuntimeError(
            "the dense backend sums frontier @ logq in float32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False (the default)")
    max_steps = max_steps or n
    k, roots, visited0, bb = _setup(key, batch, n, home, positions, stable,
                                    rows)
    K = visited0.shape[0]
    row0 = 0 if rows is None else rows[0]
    one = len(tiles) == 1 and tiles[0][0] == home
    vis, uids, bbs = [], [], []
    for dev, c0, c1, _, _ in tiles:
        if one:
            blk = visited0
        else:
            blk = _padded_bool(K, c1 - c0, dev)
            blk.copy_(visited0[:, c0:c1])
        vis.append(blk)
        uids.append(torch.arange(c0, c1, dtype=torch.int32, device=dev)
                    if stable else None)
        bbs.append(bb.to(dev) if stable else None)
    gather = _Gather(home, overlap, len(tiles))
    frontier = visited0.clone()
    parts = [frontier]
    step = 0
    while step < max_steps and _note_cells(sum(int(p.sum()) for p in parts)):
        k, sub = prng.split(k)
        full = (None if stable else
                _dense_coins(sub, batch, K, n, None, None, home, row0))
        parts = []
        for v, (dev, c0, c1, lq, cols) in enumerate(tiles):
            coin = (_dense_coins(sub, batch, K, n, uids[v], bbs[v], dev)
                    if stable else full[:, c0:c1].to(dev))
            f = gather.ready_on(frontier, dev)
            if kernel:
                new = kops.ic_frontier_step(f, vis[v], lq, coin,
                                            cols=cols).view(torch.bool)
            else:
                new = activation(f.to(torch.float32) @ lq, coin, vis[v])
            vis[v] |= new
            parts.append(new)
        frontier = gather(parts, K, n)
        step += 1
    visited = _gather_cols(vis, home, K, n)
    counter = visited.sum(dim=0, dtype=torch.int32)
    return visited.view(torch.uint8), counter, roots


#: rows per block of the stable sparse coin draw (bounds its temporaries)
STABLE_ROWS = 32


def _sparse_loop(key, edge_src, edge_dst, edge_prob, positions=None, *,
                 n_nodes: int, batch: int, max_steps: int = 0,
                 stable: bool = False, emit_l: int = 0, rows=None):
    """CSC edge-list frontier expansion (the ``sparse`` backend).

    An edge ``u -> v`` is usable when ``v`` is in the frontier, its coin
    hits and ``u`` is unvisited; usable edges scatter-or into ``u``.
    Positional coins are ``uniform(sub, (B, m)) < edge_prob`` (the
    ``ic_sparse_hits`` kernel on the card); stable coins key on the
    edge's identity ``u * n + v`` (uint32, wrapping as the reference's),
    so pow2 padding edges (prob 0) never fire.  ``edge_src``/``edge_dst``
    are int64 tensors on the sampling device.

    ``emit_l > 0`` returns the batch as index lists ``(K, emit_l)
    int32`` (ascending, sentinel ``n_nodes``) instead of bitmaps: the
    same coins, so the rows equal the bitmap rows converted after the
    fact.  A row with more than ``emit_l`` members keeps its smallest
    ``emit_l``; the engine widens and re-emits when a row comes back
    full.  ``rows=(lo, hi)`` samples just that row block of the batch.
    """
    m = edge_src.shape[0]
    max_steps = max_steps or n_nodes
    dev = edge_prob.device
    k, roots, visited, bb = _setup(key, batch, n_nodes, dev, positions,
                                   stable, rows)
    block = rows
    K = visited.shape[0]
    uid = (((edge_src * n_nodes + edge_dst) & prng.MASK32).to(torch.int32)
           if stable else None)
    frontier = visited.clone()
    step = 0
    while step < max_steps and _frontier_count(frontier):
        k, sub = prng.split(k)
        if stable:
            hit = torch.empty((K, m), dtype=torch.bool, device=dev)
            for r in range(0, K, STABLE_ROWS):
                r1 = min(r + STABLE_ROWS, K)
                hit[r:r1] = _stable_uniform(sub, uid, bb, (r, r1)) < edge_prob
        else:
            hit = kops.ic_sparse_hits(sub, edge_prob, batch, block)
        live = frontier[:, edge_dst] & hit & ~visited[:, edge_src]
        # scatter-or into src from the live (row, edge) pairs only — an
        # index expanded to (K, m) int64 would take 8 bytes per coin
        flat = live.view(-1).nonzero().squeeze(1)
        rows = torch.div(flat, m, rounding_mode="floor")
        new = torch.zeros((K, n_nodes), dtype=torch.bool, device=dev)
        new.view(-1)[rows * n_nodes + edge_src[flat - rows * m]] = True
        new &= ~visited
        visited |= new
        frontier = new
        step += 1
    counter = visited.sum(dim=0, dtype=torch.int32)
    if emit_l:
        return bitmap_to_indices(visited, emit_l), counter, roots
    return visited.view(torch.uint8), counter, roots


def search_iters(dst_offsets, max_indeg_log2: int = 32) -> int:
    """Iterations after which the walk's binary search stops moving.

    The reference runs ``max_indeg_log2`` (32) unguarded iterations.  A
    segment of length L shrinks to ``lo == hi`` within ``L.bit_length()``
    of them; the next one leaves ``lo`` at ``hi`` or ``hi + 1`` (the
    overrun: ``in_cum[hi]`` is the next vertex's first weight), and
    every later one repeats that same comparison.  So this many
    iterations, capped at the reference's count, give its answer.
    """
    deg = dst_offsets[1:] - dst_offsets[:-1]
    dmax = int(deg.max()) if deg.numel() else 0
    return min(int(max_indeg_log2), dmax.bit_length() + 2)


def _pick_in_neighbor(offs, in_src, in_cum, cur, r, iters: int):
    """The reference's binary search over the CSC segment of each row's
    ``cur`` for the first cumulative weight >= ``r``: ``iters`` unguarded
    iterations with the probe clipped into the edge array, so a search
    that runs off its segment's end lands where the reference's does."""
    m = in_src.shape[0]
    lo, hi = offs[cur], offs[cur + 1]
    for _ in range(iters):
        mid = (lo + hi) >> 1
        right = in_cum[mid.clamp(0, m - 1)] < r
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(right, hi, mid)
    return in_src[lo.clamp(0, m - 1)].long()


def _walk_loop(key, dst_offsets, in_src, in_cum, in_total, positions=None,
               *, batch: int, max_steps: int = 0, max_indeg_log2: int = 32,
               stable: bool = False, iters: int = None, rows=None):
    """Pick-at-most-one random walk (the ``walk`` backend, `WalkModel`).

    Each step the walk at ``cur`` draws one uniform ``r``: ``r >=
    total(cur)`` stops it, otherwise a binary search over the dst's
    cumulative weights picks the in-neighbour; a revisit ends the walk.
    Positional draws are ``uniform(sub, (batch,))`` (the ``uniform_draw``
    kernel on the card); stable draws key on the row identity,
    ``_u01(_mix32(_mix32(row ^ k0) ^ k1))``.  Every comparison is an f32
    ``<`` of the reference's values, so the rows are bitwise its own.
    A step marks only the B chosen cells (the reference ORs a ``(B, n)``
    one-hot).  ``iters`` is the search's iteration count
    (`search_iters`, computed here when absent).  ``rows=(lo, hi)``
    samples just that row block of the batch.

    Returns ``(visited (K, n) uint8, counter (n,) int32, roots (K,))``.
    """
    n = dst_offsets.shape[0] - 1
    m = in_src.shape[0]
    dev = in_total.device
    max_steps = max_steps or n
    if iters is None:
        iters = search_iters(dst_offsets, max_indeg_log2)
    k, roots, visited, bb = _setup(key, batch, n, dev, positions, stable,
                                   rows)
    K = visited.shape[0]
    row0 = 0 if rows is None else rows[0]
    rows = torch.arange(K, device=dev)
    offs = dst_offsets.long()
    cur = roots.long()
    active = torch.ones(K, dtype=torch.bool, device=dev)
    step = 0
    while step < max_steps and _frontier_count(active):
        k, sub = prng.split(k)
        if stable:
            k0, k1 = (prng.u32_to_i32(int(w)) for w in prng.as_key(sub))
            r = _u01(_mix32(_mix32(bb[:, 0] ^ k0) ^ k1))
        else:
            r = kops.uniform(sub, (batch,), device=dev, start=row0,
                             count=K)
        go = active & (r < in_total[cur])
        # an edgeless graph has no segment to search; its totals are 0,
        # so no walk moves
        nxt = (_pick_in_neighbor(offs, in_src, in_cum, cur, r, iters)
               if m else cur)
        revisit = visited[rows, nxt]
        go &= ~revisit
        visited[rows, nxt] = revisit | go
        cur = torch.where(go, nxt, cur)
        active = go
        step += 1
    counter = visited.sum(dim=0, dtype=torch.int32)
    return visited.view(torch.uint8), counter, roots


# ------------------------------------------------ historical entry points ----

def sample_ic_dense(key, logq, *, batch: int, max_steps: int = 0,
                    placement=None):
    """Positional dense log-semiring IC sampling (see `_dense_loop`);
    under a ``placement``, one block per theta shard."""
    if placement is not None:
        return _per_block(placement, batch, lambda dev, rows: _dense_loop(
            key, logq.to(dev), batch=batch, max_steps=max_steps, rows=rows))
    return _dense_loop(key, logq, batch=batch, max_steps=max_steps)


def sample_ic_dense_stable(key, logq, positions=None, *, batch: int,
                           max_steps: int = 0, placement=None):
    """Identity-keyed dense sampling with ``positions`` row subsets."""
    if placement is not None and positions is None:
        return _per_block(placement, batch, lambda dev, rows: _dense_loop(
            key, logq.to(dev), batch=batch, max_steps=max_steps,
            stable=True, rows=rows))
    return _dense_loop(key, logq, positions, batch=batch,
                       max_steps=max_steps, stable=True)


def sample_ic_sparse(key, edge_src, edge_dst, edge_prob, *, n_nodes: int,
                     batch: int, max_steps: int = 0, placement=None):
    """Positional edge-list IC sampling (see `_sparse_loop`)."""
    if placement is not None:
        return _per_block(placement, batch, lambda dev, rows: _sparse_loop(
            key, edge_src.long().to(dev), edge_dst.long().to(dev),
            edge_prob.to(dev), n_nodes=n_nodes, batch=batch,
            max_steps=max_steps, rows=rows))
    return _sparse_loop(key, edge_src.long(), edge_dst.long(), edge_prob,
                        n_nodes=n_nodes, batch=batch, max_steps=max_steps)


def sample_ic_sparse_stable(key, edge_src, edge_dst, edge_prob,
                            positions=None, *, n_nodes: int, batch: int,
                            max_steps: int = 0, placement=None):
    """Edge-identity-keyed sparse sampling with ``positions`` subsets."""
    if placement is not None and positions is None:
        return _per_block(placement, batch, lambda dev, rows: _sparse_loop(
            key, edge_src.long().to(dev), edge_dst.long().to(dev),
            edge_prob.to(dev), n_nodes=n_nodes, batch=batch,
            max_steps=max_steps, stable=True, rows=rows))
    return _sparse_loop(key, edge_src.long(), edge_dst.long(), edge_prob,
                        positions, n_nodes=n_nodes, batch=batch,
                        max_steps=max_steps, stable=True)


def sample_lt(key, dst_offsets, in_src, in_lt_cum, in_lt_total, *,
              batch: int, max_steps: int = 0, max_indeg_log2: int = 32,
              placement=None):
    """Positional LT RRR random walk (see `_walk_loop`)."""
    if placement is not None:
        return _per_block(placement, batch, lambda dev, rows: _walk_loop(
            key, dst_offsets.to(dev), in_src.to(dev), in_lt_cum.to(dev),
            in_lt_total.to(dev), batch=batch, max_steps=max_steps,
            max_indeg_log2=max_indeg_log2, rows=rows))
    return _walk_loop(key, dst_offsets, in_src, in_lt_cum, in_lt_total,
                      batch=batch, max_steps=max_steps,
                      max_indeg_log2=max_indeg_log2)


def sample_lt_stable(key, dst_offsets, in_src, in_lt_cum, in_lt_total,
                     positions=None, *, batch: int, max_steps: int = 0,
                     max_indeg_log2: int = 32, placement=None):
    """Identity-keyed LT walk with ``positions`` row subsets."""
    if placement is not None and positions is None:
        return _per_block(placement, batch, lambda dev, rows: _walk_loop(
            key, dst_offsets.to(dev), in_src.to(dev), in_lt_cum.to(dev),
            in_lt_total.to(dev), batch=batch, max_steps=max_steps,
            max_indeg_log2=max_indeg_log2, stable=True, rows=rows))
    return _walk_loop(key, dst_offsets, in_src, in_lt_cum, in_lt_total,
                      positions, batch=batch, max_steps=max_steps,
                      max_indeg_log2=max_indeg_log2, stable=True)


# -------------------------------------------------------------- backends ----

def _pad_edges_pow2(edge_src, edge_dst, edge_prob):
    """Pad CSC edge arrays to the next power of two with never-firing
    edges (prob 0, endpoints 0); under identity-keyed coins the padded
    sampler's output is bitwise the unpadded one's."""
    m = int(edge_src.shape[0])
    m_pad = next_pow2(m, 1)
    if m_pad == m:
        return edge_src, edge_dst, edge_prob
    pad = m_pad - m

    def grow(a):
        return torch.cat([a, torch.zeros(pad, dtype=a.dtype,
                                         device=a.device)])
    return grow(edge_src), grow(edge_dst), grow(edge_prob)


@dataclasses.dataclass(frozen=True)
class TraversalBackend:
    """One way to execute an RRR traversal: ``family`` names the model
    family it executes; ``bind(model, graph, cfg, *, stable, placement)``
    preprocesses once and returns the bound sampler, a callable of a key
    (plus keyword-only ``positions`` when stable) returning ``(visited
    (K, n) uint8, counter (n,) int32, roots (K,))``."""
    name: str
    family: str
    bind: Callable


def _bind_dense_tiled(model, graph: Graph, cfg, *, stable, placement,
                      kernel):
    """The dense or pallas sampler column-blocked over a 2D placement's
    vertex tiles (see the module docstring): logq built once on the host,
    each tile device given its column blocks and, for pallas, their
    column forms, once per bound sampler.  Row subsets (``positions``)
    run unplaced on the first shard's device, bound at first use."""
    g_host = graph.to("cpu")
    logq = logq_from_probs(g_host, _edge_probs(model, g_host))
    starts = [int(x) for x in placement.partition.starts]
    blocks = {}
    for row in placement.tiles:
        for v, dev in enumerate(row):
            if (dev, v) not in blocks:
                lq = logq[:, starts[v]:starts[v + 1]].contiguous().to(dev)
                blocks[(dev, v)] = (lq, column_form(lq) if kernel else None)
    tiles = [[(dev, starts[v], starts[v + 1]) + blocks[(dev, v)]
              for v, dev in enumerate(row)] for row in placement.tiles]
    overlap = bool(getattr(cfg, "overlap", False))
    home = {}

    def home_sampler():
        if not home:
            home["s"] = _bind_dense(model, graph.to(placement.devices[0]),
                                    cfg, stable=stable, placement=None,
                                    kernel=kernel)
        return home["s"]

    def run(key):
        out = [_dense_loop_tiled(
            key, tiles[t], batch=cfg.batch, n=graph.n, home=dev,
            rows=(lo, hi), stable=stable, kernel=kernel, overlap=overlap)
            for t, (dev, lo, hi) in enumerate(placement.blocks(cfg.batch))]
        return tuple(tuple(o[i] for o in out) for i in range(3))
    return _with_subsets(run, home_sampler, stable)


def _bind_dense(model, graph: Graph, cfg, *, stable, placement,
                kernel=False):
    if placement is not None and placement.tiles is not None:
        return _bind_dense_tiled(model, graph, cfg, stable=stable,
                                 placement=placement, kernel=kernel)
    if placement is not None:
        return _placed(lambda g: _bind_dense(
            model, g, cfg, stable=stable, placement=None, kernel=kernel),
            graph, placement, cfg.batch, stable)
    logq = logq_from_probs(graph, _edge_probs(model, graph))
    # the frontier step walks logq's column form, which depends on logq
    # alone: build it once per bound sampler, not at every BFS step
    cols = column_form(logq) if kernel else None
    if stable:
        def sample(key, positions=None, rows=None):
            return _dense_loop(key, logq, positions, batch=cfg.batch,
                               stable=True, kernel=kernel, cols=cols,
                               rows=rows)
    else:
        def sample(key, rows=None):
            return _dense_loop(key, logq, batch=cfg.batch, kernel=kernel,
                               cols=cols, rows=rows)
    sample.cols = cols      # what every step walks (None on ``dense``)
    return sample


def _bind_pallas(model, graph: Graph, cfg, *, stable, placement):
    return _bind_dense(model, graph, cfg, stable=stable,
                       placement=placement, kernel=True)


def _bind_sparse(model, graph: Graph, cfg, *, stable=False, placement=None):
    if placement is not None:
        return _placed(lambda g: _bind_sparse(model, g, cfg, stable=stable),
                       graph, placement, cfg.batch, stable)
    src, dst = graph.edge_src.long(), graph.edge_dst.long()
    prob = _edge_probs(model, graph)
    if stable:
        # pow2 padding is invisible only under identity-keyed coins; the
        # positional coin layout is a function of m, so it keeps m
        src, dst, prob = _pad_edges_pow2(src, dst, prob)

        def fn(key, positions=None, emit_l=0, rows=None):
            return _sparse_loop(key, src, dst, prob, positions,
                                n_nodes=graph.n, batch=cfg.batch,
                                stable=True, emit_l=emit_l, rows=rows)
    else:
        def fn(key, emit_l=0, rows=None):
            return _sparse_loop(key, src, dst, prob, n_nodes=graph.n,
                                batch=cfg.batch, emit_l=emit_l, rows=rows)
    # the engine routes C4 through this tag: an IndexStore asks a tagged
    # sampler for index rows (``emit_l``) instead of bitmaps
    fn.supports_index_emit = True
    return fn


def _bind_walk(model, graph: Graph, cfg, *, stable, placement):
    if placement is not None:
        return _placed(lambda g: _bind_walk(model, g, cfg, stable=stable,
                                            placement=None),
                       graph, placement, cfg.batch, stable)
    tables = tuple(t.to(graph.device) for t in model.walk_tables(graph))
    # the search's iteration count needs the largest in-degree: read it
    # once per bound sampler, not at every step
    iters = search_iters(tables[0])
    if stable:
        def sample(key, positions=None, rows=None):
            return _walk_loop(key, *tables, positions, batch=cfg.batch,
                              stable=True, iters=iters, rows=rows)
    else:
        def sample(key, rows=None):
            return _walk_loop(key, *tables, batch=cfg.batch, iters=iters,
                              rows=rows)
    return sample


DENSE_BACKEND = TraversalBackend("dense", "coins", _bind_dense)
SPARSE_BACKEND = TraversalBackend("sparse", "coins", _bind_sparse)
PALLAS_BACKEND = TraversalBackend("pallas", "coins", _bind_pallas)
WALK_BACKEND = TraversalBackend("walk", "walk", _bind_walk)

_BACKEND_REGISTRY: dict = {}


def register_backend(backend: TraversalBackend) -> None:
    """Register a `TraversalBackend` under its name (overwrites
    silently)."""
    _BACKEND_REGISTRY[backend.name] = backend


def get_backend(name: str) -> TraversalBackend:
    try:
        return _BACKEND_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown traversal backend {name!r}; registered: "
            f"{sorted(_BACKEND_REGISTRY)}") from None


def registered_backends():
    return sorted(_BACKEND_REGISTRY)


for _b in (DENSE_BACKEND, SPARSE_BACKEND, PALLAS_BACKEND, WALK_BACKEND):
    register_backend(_b)


# ----------------------------------------------------------- composition ----

def _check_family(model, backend) -> None:
    if backend.family != model.family:
        raise ValueError(
            f"backend {backend.name!r} executes {backend.family!r}-family "
            f"models; model {model.name!r} is {model.family!r}-family "
            f"(coin models compose with dense/sparse/pallas, walk models "
            f"with walk)")


def composed_name(model: str, backend: str, stable: bool = False) -> str:
    """Canonical registry spelling ``"<model>/<backend>[+stable]"``."""
    return f"{model}/{backend}" + ("+stable" if stable else "")


def make_sampler(model, backend=None, *, stable: bool = False):
    """Compose a model and a backend (registry names or instances) into a
    sampler factory ``factory(graph, cfg, *, placement=None) -> bound
    sampler``; ``backend`` defaults to the family's reference backend
    ("dense" for coins, "walk" for walks).  Families that do not match
    fail here.  Names re-resolve at each bind, so re-registering a model
    reaches factories composed before."""
    m = get_model(model) if isinstance(model, str) else model
    if backend is None:
        backend = "dense" if m.family == "coins" else "walk"
    b = get_backend(backend) if isinstance(backend, str) else backend
    _check_family(m, b)

    def factory(graph: Graph, cfg, *, placement=None):
        mm = get_model(model) if isinstance(model, str) else model
        bb = get_backend(backend) if isinstance(backend, str) else backend
        _check_family(mm, bb)
        return bb.bind(mm, graph, cfg, stable=stable, placement=placement)

    factory.__name__ = f"sampler_{m.name}_{b.name}" + (
        "_stable" if stable else "")
    factory.model, factory.backend, factory.stable = m, b, stable
    return factory


def sampler_matrix():
    """Every valid ``(model_name, backend_name)`` composition over the
    registered models and backends."""
    return [(mn, bn) for mn in registered_models()
            for bn in registered_backends()
            if _BACKEND_REGISTRY[bn].family == _MODEL_REGISTRY[mn].family]


# ------------------------------------------------------- sampler registry ----

_SAMPLER_REGISTRY: dict = {}

# historical monolithic spellings -> canonical compositions; resolving one
# warns once per name per process
_LEGACY_ALIASES = {
    "IC-dense": "IC/dense",
    "IC-sparse": "IC/sparse",
    "LT": "LT/walk",
    "IC-dense-stable": "IC/dense+stable",
    "IC-sparse-stable": "IC/sparse+stable",
    "LT-stable": "LT/walk+stable",
}
_LEGACY_WARNED: set = set()


def register_sampler(name: str, factory=None):
    """Register a sampler factory under ``name`` (overwrites silently);
    usable as a decorator."""
    if factory is None:
        def deco(f):
            _SAMPLER_REGISTRY[name] = f
            return f
        return deco
    _SAMPLER_REGISTRY[name] = factory
    return factory


def _parse_composed(name: str):
    """``(model, backend, stable)`` when ``name`` is a canonical
    composition over registered axes, else None."""
    mdl, sep, rest = name.partition("/")
    if not sep:
        return None
    bkd, plus, stb = rest.partition("+")
    if plus and stb != "stable":
        return None
    if mdl in _MODEL_REGISTRY and bkd in _BACKEND_REGISTRY:
        return mdl, bkd, bool(plus)
    return None


def get_sampler(name: str):
    hit = _SAMPLER_REGISTRY.get(name)
    if hit is not None:
        return hit
    alias = _LEGACY_ALIASES.get(name)
    if alias is not None:
        if name not in _LEGACY_WARNED:
            _LEGACY_WARNED.add(name)
            mdl, _, rest = alias.partition("/")
            bkd, _, stb = rest.partition("+")
            spelling = f"make_sampler({mdl!r}, {bkd!r}" + (
                ", stable=True)" if stb else ")")
            warnings.warn(
                f"sampler name {name!r} is a legacy monolithic spelling; "
                f"use {alias!r} (= {spelling}) instead — results are "
                f"seed-for-seed identical",
                DeprecationWarning, stacklevel=2)
        return _SAMPLER_REGISTRY[alias]
    axes = _parse_composed(name)
    if axes is not None:
        mdl, bkd, stable = axes
        factory = make_sampler(mdl, bkd, stable=stable)
        _SAMPLER_REGISTRY[name] = factory
        return factory
    raise ValueError(
        f"unknown sampler {name!r}; registered: {registered_samplers()}")


def registered_samplers():
    """Every resolvable name: the canonical matrix, user registrations
    and the legacy aliases."""
    return sorted(set(_SAMPLER_REGISTRY) | set(_LEGACY_ALIASES))


for _mn, _bn in sampler_matrix():
    for _s in (False, True):
        register_sampler(composed_name(_mn, _bn, _s),
                         make_sampler(_mn, _bn, stable=_s))


def default_sampler_name(graph: Graph, cfg) -> str:
    """Resolve ``cfg`` to a canonical name: coin models take the dense
    backend up to ``cfg.dense_sampler_max_n`` and the sparse one above
    it, walk models the walk backend; ``cfg.backend`` overrides (a family
    mismatch fails here) and ``cfg.stable`` selects the identity-keyed
    form."""
    m = get_model(cfg.model)
    backend = getattr(cfg, "backend", None)
    if backend is None:
        if m.family == "walk":
            backend = "walk"
        else:
            backend = ("dense" if graph.n <= cfg.dense_sampler_max_n
                       else "sparse")
    else:
        _check_family(m, get_backend(backend))
    return composed_name(m.name, backend, bool(getattr(cfg, "stable",
                                                       False)))


def stable_variant(name: str) -> str:
    """The delta-stable spelling of a sampler name: canonical names gain
    ``+stable``, legacy aliases ``-stable``, unknown names pass through."""
    if name.endswith("+stable") or name.endswith("-stable"):
        return name
    if name in _LEGACY_ALIASES:
        return f"{name}-stable"
    if (f"{name}+stable" in _SAMPLER_REGISTRY
            or _parse_composed(name) is not None):
        return f"{name}+stable"
    return name


def bind_sampler(factory, graph: Graph, cfg, placement=None):
    """Instantiate a factory, forwarding ``placement`` only when the
    factory declares it (keyword ``placement`` or ``**kwargs``)."""
    if placement is not None:
        params = inspect.signature(factory).parameters
        takes_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                       for p in params.values())
        if "placement" in params or takes_kw:
            return factory(graph, cfg, placement=placement)
    return factory(graph, cfg)
