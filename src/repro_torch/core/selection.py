"""Find_Most_Influential_Set (paper Alg. 2): greedy max-coverage over a
bitmap arena or C4 index lists (``repro.core.selection``:
``select_dense``, ``select_fused``, ``select_sparse``, ``greedy_select``
and the strategy registry).

  * ``rebuild``   — EfficientIMM (paper C5): each round recomputes the
    counter from the surviving sets, ``counter = alive @ R``;
  * ``decrement`` — the Ripples baseline: a running counter minus the
    covered sets' contribution.

Every counter goes through `repro_torch.kernels.ops`: the
``coverage_matvec`` kernel on the card (``torch.matmul`` has no uint8
product, and ``R.float()`` would copy the arena at 4 bytes a cell), the
plain version on the CPU.  ``fused-rebuild`` takes each round's winner
straight from the ``fused_select`` kernel.  Counts are exact integers,
and every argmax keeps ``jnp.argmax``'s first-maximum rule, so all four
strategies pick the JAX package's seeds.  ``valid`` may be any row mask.

Index lists ``(theta, L) int32`` (sentinel ``n``) count with a scatter
of each row's alive weight into its members (`bincount_weighted` over
the real members, plain PyTorch: no Pallas kernel exists for it) and
test membership by comparing each row with the winner; the reference counts in f32, which
holds these integers exactly, so the int32 counts pick the same seeds.
The ``fused-*`` methods have no index-list kernel and run the plain
strategies, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch import mesh as mesh_ops
from repro_torch.graphs.partition import vertex_partition
from repro_torch.kernels import ops as kops
from repro_torch.sparse.scatter import bincount_weighted


def _member(R, v):
    """``(theta,) bool``: which rows contain vertex ``v`` (a 0-dim tensor)."""
    return R.index_select(1, v.view(1).long()).squeeze(1) > 0


def _finish(valid, seeds, gains):
    n_valid = valid.sum(dtype=torch.float32).clamp_min(1.0)
    return seeds, gains.sum(dtype=torch.float32) / n_valid, gains


def greedy(valid, k: int, method: str, pick, count, member):
    """The greedy loop shared by every layout: ``count(mask)`` is the
    ``(n,)`` counter of a row mask, ``member(v)`` the ``(theta,) bool``
    rows holding ``v``, and ``pick(alive, counter)`` the round's vertex
    (``counter`` is None on rebuild rounds)."""
    if method not in ("rebuild", "decrement"):
        raise ValueError(f"unknown method {method}")
    seeds = torch.zeros(k, dtype=torch.int32, device=valid.device)
    gains = torch.zeros(k, dtype=torch.int32, device=valid.device)
    alive = valid.clone()
    counter = count(alive) if method == "decrement" else None
    for i in range(k):
        v = pick(alive, counter)
        covered = member(v) & alive
        seeds[i] = v
        gains[i] = covered.sum(dtype=torch.int32)
        if method == "decrement":
            counter = counter - count(covered)
        alive &= ~covered
    return _finish(valid, seeds, gains)


def _dense_greedy(R, valid, k: int, method: str, pick):
    return greedy(valid, k, method, pick,
                  lambda mask: kops.coverage_matvec(mask, R),
                  lambda v: _member(R, v))


def select_dense(R, valid, k: int, method: str = "rebuild"):
    """R: (theta, n) uint8 bitmaps; valid: (theta,) bool.  Returns
    (seeds (k,) int32, covered_frac () f32, gains (k,) int32)."""
    def pick(alive, counter):
        if counter is None:
            counter = kops.coverage_matvec(alive, R)
        return torch.argmax(counter)
    return _dense_greedy(R, valid, k, method, pick)


def select_fused(R, valid, n: int, k: int, method: str = "rebuild"):
    """`select_dense` with each rebuild round reduced by the
    ``fused_select`` kernel: the round's ``(n,)`` counter never exists.
    Decrement rounds keep a counter through ``coverage_matvec``."""
    def pick(alive, counter):
        if counter is None:
            return kops.fused_select(alive, R)[1]
        return torch.argmax(counter)
    return _dense_greedy(R, valid, k, method, pick)


def select_sparse(R_idx, valid, n: int, k: int, method: str = "rebuild"):
    """R_idx: (theta, L) int32 index lists, sentinel ``n``; valid:
    (theta,) bool.  Returns (seeds (k,) int32, covered_frac () f32,
    gains (k,) int32).  The lists' members are gathered once (ids and
    their rows), so a round's count scatters only real members, never
    the sentinel padding into one contended bucket."""
    flat = R_idx.reshape(-1)
    pos = (flat < n).nonzero().squeeze(1)
    ids = flat[pos]
    rows = torch.div(pos, R_idx.shape[1], rounding_mode="floor")

    def count(mask):
        return bincount_weighted(ids, mask.to(torch.int32)[rows], n)

    def pick(alive, counter):
        return torch.argmax(count(alive) if counter is None else counter)

    return greedy(valid, k, method, pick, count,
                  lambda v: (R_idx == v).any(dim=1))


def greedy_select(R_or_idx, valid, k: int, *, n: int = None,
                  representation: str = "bitmap", method: str = "rebuild"):
    """Unified entry point: bitmap rows or index lists."""
    if representation == "bitmap":
        return select_dense(R_or_idx, valid, k, method)
    if representation == "indices":
        if n is None:
            raise ValueError("index-list selection needs n")
        return select_sparse(R_or_idx, valid, n, k, method)
    raise ValueError(representation)


# -------------------------------------------------------------- sharded ----
#
# The mesh strategies run the reference's shard_map bodies tile by tile:
# every round each tile reduces its own rows over its own columns, the
# counter is summed over the theta axis (one partial per vertex block),
# each vertex block offers its first argmax as a (value, global id) pair,
# the pairs are gathered and the first block with the maximum wins, and
# the winner's rows are tested tile by tile and or-ed over the vertex
# axis.  Only reduced tensors cross tiles, every one stays on a device,
# and no round reads a value back on the host.


def _vertex_sharded_pick(counters, starts, home):
    """The round's winner from one ``(n_local,)`` float32 counter per
    vertex block: pad columns (past a block's size) masked to -1, each
    block's first argmax as a global id, the first block with the
    maximum.  Returns a 0-dim int64 tensor on ``home``."""
    vals, ids = [], []
    for v, c in enumerate(counters):
        size = starts[v + 1] - starts[v]
        iota = torch.arange(c.shape[0], device=c.device)
        c = torch.where(iota < size, c, torch.full_like(c, -1.0))
        j = torch.argmax(c)
        vals.append(c[j])
        ids.append(j + starts[v])
    vals = mesh_ops.all_gather(vals, home)
    ids = mesh_ops.all_gather(ids, home)
    return ids[torch.argmax(vals)]


def _sharded_greedy(tiles, valid, k: int, method: str, *, n: int,
                    partition, partial_of, member_local):
    """The greedy loop over a ``[Dt][Dv]`` grid of tiles with one row
    mask per theta shard: ``partial_of(t, v, mask)`` is tile ``(t, v)``'s
    ``(n_local,)`` count of the rows ``mask`` keeps (on the tile's
    device), ``member_local(t, v, lv)`` its ``(rows,) bool`` membership
    of local column ``lv`` (a 0-dim tensor on the tile's device).
    Returns the reference's ``(seeds, covered_frac, gains)`` on the
    first tile's device."""
    if method not in ("rebuild", "decrement"):
        raise ValueError(f"unknown method {method}")
    Dt, Dv = len(tiles), len(tiles[0])
    devs = [[tiles[t][v].device for v in range(Dv)] for t in range(Dt)]
    home = devs[0][0]
    part = partition if partition is not None else vertex_partition(n, Dv)
    starts = [int(x) for x in part.starts]

    def counters(masks):
        """Per vertex block, the partials of ``masks`` summed over the
        theta axis (float32, on the block's first tile's device)."""
        return [mesh_ops.psum(
            [partial_of(t, v, masks[t].to(devs[t][v])).to(torch.float32)
             for t in range(Dt)], devs[0][v]) for v in range(Dv)]

    seeds = torch.zeros(k, dtype=torch.int32, device=home)
    gains = torch.zeros(k, dtype=torch.int32, device=home)
    alive = [m.clone() for m in valid]
    counter = counters(alive) if method == "decrement" else None
    for i in range(k):
        win = _vertex_sharded_pick(
            counters(alive) if counter is None else counter, starts, home)
        covered = []
        for t in range(Dt):
            parts = []
            for v in range(Dv):
                lv = win.to(devs[t][v]) - starts[v]
                ok = (lv >= 0) & (lv < starts[v + 1] - starts[v])
                lv = lv.clamp(0, part.block - 1)
                parts.append(member_local(t, v, lv) & ok)
            covered.append(mesh_ops.psum_or(parts, valid[t].device)
                           & alive[t])
        seeds[i] = win
        gains[i] = mesh_ops.psum(
            [c.sum(dtype=torch.int32) for c in covered], home)
        if counter is not None:
            dec = counters(covered)
            counter = [c - d for c, d in zip(counter, dec)]
        for t in range(Dt):
            alive[t] &= ~covered[t]
    n_valid = mesh_ops.psum([m.sum(dtype=torch.int32) for m in valid],
                            home).to(torch.float32).clamp_min(1.0)
    return seeds, gains.sum(dtype=torch.float32) / n_valid, gains


def _tiled(R, valid, n, mesh, theta_axes, vertex_axis, partition, codec):
    """``(tiles, valid, partition, codec)`` of a strategy's arena: a
    `ShardedStore` view's own tiles, or — for a single-device store on a
    mesh, whose arena the reference scatters on entry — its valid rows
    (decoded) written into a `ShardedStore` on ``mesh``, in blocks of
    rows of about 1 GiB, so no second copy of the whole arena is made on
    the way."""
    if isinstance(R, tuple):
        return R, valid, partition, codec
    from repro_torch.core.store import ShardedStore
    store = ShardedStore(n, mesh=mesh, theta_axes=theta_axes,
                         vertex_axis=vertex_axis,
                         capacity=int(valid.sum()), partition=partition)
    step = max(1, (1 << 30) // max(R.stride(0), 1) // store.D) * store.D
    for lo in range(0, R.shape[0], step):
        rows = R[lo:lo + step][valid[lo:lo + step]]
        if codec is not None and codec.kind != "bitmap":
            rows = codec.decode(rows)
        if rows.shape[0]:
            store.add_batch(rows)
    tiled = store.view()
    return tiled.R, tiled.valid, store.partition, store.codec


def select_dense_sharded(mesh, R, valid, k: int, *, theta_axes=("data",),
                         vertex_axis=None, method: str = "rebuild",
                         n: int = None, partition=None, codec=None):
    """Greedy selection over a meshed arena (paper C1): ``R`` the
    ``[Dt][Dv]`` grid of tiles (a `ShardedStore` view's; bitmap, packed
    or token rows as ``codec`` says, ``n_local`` columns each),
    ``valid`` one row mask per theta shard.  Each tile's partial counter
    comes from a kernel — ``coverage_matvec`` over bitmap tiles,
    ``packed_count`` over packed ones, ``token_count`` over token ones —
    and the winner's column is decoded tile by tile
    (``codec.decode_cols``).  ``rebuild`` re-counts the surviving rows
    every round; ``decrement`` keeps the counter and subtracts the
    covered rows' counts.  Seeds, gains and covered_frac are bitwise
    the single-device strategies' on the same rows, on any mesh and
    either column layout."""
    from repro_torch.core.pack.codec import BitmapCodec
    tiles, valid, partition, codec = _tiled(R, valid, n, mesh, theta_axes,
                                            vertex_axis, partition, codec)
    if codec is None:
        codec = BitmapCodec(tiles[0][0].shape[1])
    n_tile = codec.n_cols

    if codec.kind == "bitmap":
        def partial_of(t, v, mask):
            return kops.coverage_matvec(mask, tiles[t][v])
    elif codec.kind == "packed":
        def partial_of(t, v, mask):
            return kops.packed_count(tiles[t][v], mask, n=n_tile)
    else:
        def partial_of(t, v, mask):
            return kops.token_count(tiles[t][v], mask, n=n_tile)

    def member_local(t, v, lv):
        return codec.decode_cols(tiles[t][v], lv.view(1))[:, 0]

    return _sharded_greedy(tiles, valid, k, method, n=n, partition=partition,
                           partial_of=partial_of, member_local=member_local)


def select_sparse_sharded(mesh, R_idx, valid, n: int, k: int, *,
                          theta_axes=("data",), vertex_axis=None,
                          method: str = "rebuild", partition=None):
    """Greedy selection over meshed C4 index lists: ``R_idx`` the
    ``[Dt][Dv]`` grid of ``(cap_local, l_pad) int32`` tiles of *local*
    ids (sentinel ``n_local``), as `ShardedStore.index_view` emits them.
    Each tile scatters its rows' alive weights into an ``(n_local,)``
    partial (its members gathered once), membership of the winner is a
    tile-local compare; selections equal the dense strategies'."""
    Dv = len(R_idx[0])
    part = partition if partition is not None else vertex_partition(n, Dv)
    n_local = part.block
    members = [[None] * Dv for _ in R_idx]
    for t, row in enumerate(R_idx):
        for v, lists in enumerate(row):
            flat = lists.reshape(-1)
            pos = (flat < n_local).nonzero().squeeze(1)
            members[t][v] = (flat[pos], torch.div(
                pos, lists.shape[1], rounding_mode="floor"))

    def partial_of(t, v, mask):
        ids, rows = members[t][v]
        return bincount_weighted(ids, mask.to(torch.int32)[rows], n_local)

    def member_local(t, v, lv):
        return (R_idx[t][v] == lv).any(dim=1)

    return _sharded_greedy(R_idx, valid, k, method, n=n, partition=part,
                           partial_of=partial_of, member_local=member_local)


def select_fused_sharded(mesh, R, valid, k: int, **kw):
    """The fused sharded strategy: each tile's counter already comes from
    a kernel in `select_dense_sharded`, so the two are one function here
    (the single-device ``fused_select`` argmax cannot cross tiles; the
    reference's sharded path also reduces through ``coverage_matvec``)."""
    return select_dense_sharded(mesh, R, valid, k, **kw)


# ------------------------------------------ Ripples-faithful baseline ----

def select_vertex_partitioned(R_idx, valid, n: int, k: int,
                              block: int = 1024):
    """The Ripples work pattern the paper profiles (§III Challenge 1):
    vertices partitioned across workers, each binary-searching every
    sorted RRR set for its vertices — O(n * theta * log L) loads per
    counter build against EfficientIMM's O(theta * L) scatter
    (``repro.core.selection.select_vertex_partitioned``).  ``R_idx`` are
    ascending lists with sentinel ``n``; vertices are searched ``block``
    at a time.  The counter is decremental, re-searching every covered
    set for every vertex."""
    theta, L = R_idx.shape
    rows = R_idx.contiguous()

    def count(mask):
        out = torch.zeros(n, dtype=torch.float32, device=R_idx.device)
        for lo in range(0, n, block):
            v = torch.arange(lo, min(lo + block, n), device=R_idx.device,
                             dtype=R_idx.dtype)
            pos = torch.searchsorted(
                rows, v.expand(theta, -1).contiguous()).clamp_(max=L - 1)
            hit = rows.gather(1, pos) == v
            out[lo:lo + v.numel()] = (hit & mask[:, None]).sum(
                dim=0, dtype=torch.int32).to(torch.float32)
        return out

    def member(v):
        pos = torch.searchsorted(
            rows, v.view(1, 1).expand(theta, 1).to(rows.dtype).contiguous()
        ).clamp_(max=L - 1)
        return (rows.gather(1, pos) == v).squeeze(1)

    return greedy(valid, k, "decrement",
                  lambda alive, counter: torch.argmax(counter),
                  count, member)


# ------------------------------------------------- SelectionStrategy API ----
#
# A strategy is ``fn(view, k, **opts) -> (seeds, covered_frac, gains)``
# keyed "<method>-<layout>"; the dense (bitmap) layout registers here, the
# packed and compressed layouts in `repro_torch.core.pack.selection`.

SELECTION_STRATEGIES = {}


def register_selection(name: str, fn) -> None:
    """Register (or shadow) a selection strategy."""
    SELECTION_STRATEGIES[name] = fn


def get_selection(method: str, layout: str):
    name = f"{method}-{layout}"
    try:
        return SELECTION_STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"no selection strategy {name!r}; registered: "
            f"{sorted(SELECTION_STRATEGIES)}")


def _dense_strategy(method):
    def run(view, k, **_):
        return select_dense(view.R, view.valid, k, method)
    return run


def _fused_dense_strategy(method):
    def run(view, k, **_):
        return select_fused(view.R, view.valid, view.n, k, method)
    return run


def _sparse_strategy(method):
    def run(view, k, **_):
        return select_sparse(view.R, view.valid, view.n, k, method)
    return run


def _sharded_strategy(method):
    def run(view, k, *, mesh=None, theta_axes=("data",), vertex_axis=None,
            partition=None, codec=None, **_):
        if mesh is None:
            raise ValueError("sharded selection needs a mesh")
        return select_dense_sharded(
            mesh, view.R, view.valid, k, theta_axes=theta_axes,
            vertex_axis=vertex_axis, method=method, n=view.n,
            partition=partition, codec=codec)
    return run


def _sharded_sparse_strategy(method):
    def run(view, k, *, mesh=None, theta_axes=("data",), vertex_axis=None,
            partition=None, **_):
        if mesh is None:
            raise ValueError("sharded selection needs a mesh")
        return select_sparse_sharded(
            mesh, view.R, view.valid, view.n, k, theta_axes=theta_axes,
            vertex_axis=vertex_axis, method=method, partition=partition)
    return run


for _m in ("rebuild", "decrement"):
    register_selection(f"{_m}-dense", _dense_strategy(_m))
    register_selection(f"{_m}-sparse", _sparse_strategy(_m))
    register_selection(f"fused-{_m}-dense", _fused_dense_strategy(_m))
    # index lists have no kernel: the fused methods run the plain
    # strategies, so C4 under a fused method never dead-ends
    register_selection(f"fused-{_m}-sparse", _sparse_strategy(_m))
    register_selection(f"{_m}-sharded", _sharded_strategy(_m))
    register_selection(f"{_m}-sharded-sparse", _sharded_sparse_strategy(_m))
    # every sharded round already counts through the kernels
    register_selection(f"fused-{_m}-sharded", _sharded_strategy(_m))
    register_selection(f"fused-{_m}-sharded-sparse",
                       _sharded_sparse_strategy(_m))
