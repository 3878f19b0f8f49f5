"""Near-tie classification of dense-sampler divergences.

Two dense samplers fed the same key (the port's ``dense`` and ``pallas``
backends, or the port and the reference) test each coin against
``p = -expm1(sum_v frontier[b, v] * logq[v, u])`` computed in f32, and
they sum in different orders (or with f32 ``expm1``/``log1p`` of other
libraries).  A coin that sits within a few ulps of ``p`` may then fall
on either side.  Such a flip is a **near-tie**: at the first BFS step
``t`` where the two runs differ, both had the same ``(frontier, visited,
rand)``, and ``|rand[b, u] - p64| <= 4 ulp_f32(p64)`` with ``p64`` summed
in float64.  Any other difference is a fault.

MoE routing has the same kind of flip: two top-k selections over float32
router probabilities computed in different orders may pick different
experts where two probabilities lie within a few ulps (`classify_topk`).

Rows of a batch evolve independently (each row's coins depend on the
step key and its own position), so every row that differs at the end is
traced back to its own first differing step by bisecting on
``max_steps``, and classified there on inputs rebuilt from run ``a``'s
state: ``visited_{t-1}`` and ``frontier_{t-1} = visited_{t-1} &
~visited_{t-2}`` (the roots at ``t = 1``).
"""
from __future__ import annotations

import numpy as np

#: the near-tie window, in float32 ulps of p
TIE_ULPS = 4


def ulp_f32(x) -> np.ndarray:
    """The float32 spacing at ``|x|``."""
    return np.spacing(np.abs(np.asarray(x, np.float64)).astype(np.float32))


def _host(x) -> np.ndarray:
    """numpy of a numpy array or a tensor on any device."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def p64(frontier, logq, b, u) -> np.ndarray:
    """``-expm1(frontier[b] @ logq[:, u])`` in float64 for cells
    ``(b, u)``; only those rows and columns are read (numpy arrays or
    tensors)."""
    b, u = np.asarray(b, np.int64), np.asarray(u, np.int64)
    f = _host(frontier[b]).astype(bool).astype(np.float64)
    q = _host(logq[:, u]).astype(np.float64).T
    return -np.expm1((f * q).sum(axis=1))


def classify_cells(frontier, logq, rand, b, u):
    """``(p64, is_tie)`` for the differing cells ``(b, u)`` of one step."""
    p = p64(frontier, logq, b, u)
    r = _host(rand[np.asarray(b, np.int64), np.asarray(u, np.int64)])
    return p, np.abs(r.astype(np.float64) - p) <= TIE_ULPS * ulp_f32(
        p).astype(np.float64)


def classify_runs(run_a, run_b, coins, logq, roots, *,
                  max_steps: int) -> dict:
    """Trace and classify every row on which two dense runs differ.

    ``run_x(t)`` gives the ``(K, n)`` visited rows after ``t`` BFS steps
    (numpy, 0/1); ``t = max_steps`` must be the whole run.  ``coins(t)``
    gives step ``t``'s ``(K, n)`` float32 draw (1-based), ``roots`` the
    ``(K,)`` roots and ``logq`` the ``(n, n)`` table to classify with.
    Returns ``{"rows", "cells", "ties", "faults", "steps"}``: the rows
    that differ at the end, the differing cells at their first step, how
    many of those are near-ties, and a description of each fault (a cell
    that is not a near-tie, or inputs that already differ).
    """
    memo: dict = {}

    def state(t):
        if t not in memo:
            memo[t] = (np.asarray(run_a(t), bool), np.asarray(run_b(t), bool))
        return memo[t]

    a_end, b_end = state(max_steps)
    pending = np.flatnonzero((a_end != b_end).any(axis=1))
    report = {"rows": int(pending.size), "cells": 0, "ties": 0,
              "faults": [], "steps": []}
    lo = 0                     # every pending row agrees after lo steps
    while pending.size:
        hi = max_steps
        # the first t in (lo, hi] where a pending row differs
        while hi - lo > 1:
            mid = (lo + hi) // 2
            a, b = state(mid)
            if (a[pending] != b[pending]).any():
                hi = mid
            else:
                lo = mid
        t = hi
        a_t, b_t = state(t)
        rows = pending[(a_t[pending] != b_t[pending]).any(axis=1)]
        n = a_t.shape[1]
        onehot = np.zeros((len(roots), n), bool)
        onehot[np.arange(len(roots)), np.asarray(roots)] = True
        prev_a, prev_b = state(t - 1) if t > 1 else (onehot, onehot)
        prev2_a, prev2_b = state(t - 2) if t > 2 else (onehot, onehot)
        if t == 1:
            frontier = onehot
        else:
            frontier = prev_a & ~prev2_a
        same = ((prev_a[rows] == prev_b[rows]).all()
                and (prev2_a[rows] == prev2_b[rows]).all())
        if not same:
            report["faults"].append(
                f"step {t}: rows {rows.tolist()} differ before the step")
        rr, uu = np.nonzero(a_t[rows] != b_t[rows])
        bb = rows[rr]
        draw = _host(coins(t))
        p, tie = classify_cells(frontier, logq, draw, bb, uu)
        rand = draw[bb, uu]
        report["cells"] += int(bb.size)
        report["ties"] += int(tie.sum())
        report["steps"].append(t)
        for i in np.flatnonzero(~tie):
            report["faults"].append(
                f"step {t}: cell ({int(bb[i])}, {int(uu[i])}) rand "
                f"{float(rand[i])!r} vs p64 {float(p[i])!r} is not a "
                f"near-tie")
        pending = np.setdiff1d(pending, rows)
        lo = t
    return report


def classify_topk(x, router, idx_a, idx_b) -> dict:
    """Classify the tokens on which two top-k routings ``idx_a``,
    ``idx_b (T, k)`` of ``x (T, d) @ router (d, E)`` differ.  At a
    token's first differing choice ``j`` the two picked experts ``e_a``,
    ``e_b`` are a near-tie when their float64 softmax probabilities lie
    within ``TIE_ULPS`` float32 ulps of each other.  Returns ``{"tokens",
    "ties", "faults"}``."""
    a, b = _host(idx_a).astype(np.int64), _host(idx_b).astype(np.int64)
    rows = np.flatnonzero((a != b).any(axis=1))
    logits = _host(x).astype(np.float64) @ _host(router).astype(np.float64)
    z = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = z / z.sum(axis=1, keepdims=True)
    report = {"tokens": int(rows.size), "ties": 0, "faults": []}
    for t in rows:
        j = int(np.flatnonzero(a[t] != b[t])[0])
        pa, pb = probs[t, a[t, j]], probs[t, b[t, j]]
        if abs(pa - pb) <= TIE_ULPS * float(ulp_f32(max(pa, pb))):
            report["ties"] += 1
        else:
            report["faults"].append(
                f"token {t}: choice {j} is expert {a[t, j]} (p64 {pa!r}) "
                f"vs {b[t, j]} (p64 {pb!r}), not a near-tie")
    return report
