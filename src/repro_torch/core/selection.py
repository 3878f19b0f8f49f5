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
        if layout.startswith("sharded"):
            raise NotImplementedError(
                f"selection strategy {name!r} is not ported yet (the "
                f"sharded layouts: ROADMAP A8)")
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


for _m in ("rebuild", "decrement"):
    register_selection(f"{_m}-dense", _dense_strategy(_m))
    register_selection(f"{_m}-sparse", _sparse_strategy(_m))
    register_selection(f"fused-{_m}-dense", _fused_dense_strategy(_m))
    # index lists have no kernel: the fused methods run the plain
    # strategies, so C4 under a fused method never dead-ends
    register_selection(f"fused-{_m}-sparse", _sparse_strategy(_m))
