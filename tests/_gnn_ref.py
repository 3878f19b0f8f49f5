"""Shared helpers of the GNN parity tests (``tests/test_torch_gnn.py``,
``test_torch_irreps.py``, ``test_torch_gnn_sampler.py``): the reference's
parameters and functions, jitted once a process, and the comparisons.

The reference's GNN functions unroll into thousands of small XLA ops; run
op by op they compile each on first use (~15 s for one Equiformer
gradient), so the tests call them under ``jax.jit`` with the config and
the node count static."""
import functools

import jax
import numpy as np
import torch

from repro_torch.convert import gnn_params_from_jax
from repro_torch.models import common

TOL = 1e-4
BF16_TOL = 1e-2


def to_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float64)


def close(got, want, tol=TOL):
    """Every element within ``tol * (1 + |want|)``, and non-finite where
    ``want`` is."""
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert np.array_equal(np.isfinite(g), np.isfinite(w))
    fin = np.isfinite(w)
    err = np.abs(g[fin] - w[fin]) / (1 + np.abs(w[fin]))
    assert (err <= tol).all(), err.max()


def sorted_tree(tree):
    """A port tree with its dicts in key order, as ``jax.tree`` walks
    them."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [sorted_tree(v) for v in tree]
    return tree


def close_trees(got, want, tol=TOL):
    """Leaf for leaf, in the reference's order and structure."""
    jl = jax.tree.leaves(want)
    tl = common.tree_leaves(sorted_tree(got))
    assert len(jl) == len(tl)
    for g, w in zip(tl, jl):
        close(g, w, tol)


@functools.lru_cache(maxsize=None)
def _jitted(fn, static, grad):
    f = jax.value_and_grad(fn) if grad else fn
    return jax.jit(f, static_argnums=static)


def ref(fn, *args, static=(1, -1)):
    """``fn(*args)`` of the reference, jitted with ``static`` positions
    (the config and the node count by default)."""
    n = len(args)
    return _jitted(fn, tuple(i % n for i in static), False)(*args)


def ref_vg(loss_fn, *args, static=(1, -1)):
    """``jax.value_and_grad(loss_fn)(*args)``, jitted (the config and the
    node count static by default)."""
    n = len(args)
    return _jitted(loss_fn, tuple(i % n for i in static), True)(*args)


@functools.lru_cache(maxsize=None)
def _jax_params(init_fn, cfg, seed):
    return jax.tree.map(np.asarray, jax.jit(init_fn, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg))


def params(init_fn, cfg, seed=0):
    """``(reference params, the port's converted copy on the host)``."""
    jp = _jax_params(init_fn, cfg, seed)
    return jp, gnn_params_from_jax(jp, device="cpu")


def graph(n=14, e=50, seed=0, d_feat=8):
    """Node features, positions and random edges (numpy)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d_feat)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32))


def t(*arrays):
    """numpy arrays as (writable) host tensors."""
    return [torch.from_numpy(np.array(a)) for a in arrays]


def rotation(th=0.6):
    return np.array([[np.cos(th), -np.sin(th), 0.0],
                     [np.sin(th), np.cos(th), 0.0],
                     [0.0, 0.0, 1.0]], np.float32)
