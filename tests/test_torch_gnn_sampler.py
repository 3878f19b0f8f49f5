"""The GNNs' input path in the port, held to the JAX package: the fan-out
neighbour sampler (``repro_torch.graphs.sampler``, ids bitwise JAX's),
the planted-partition node features (``repro_torch.data.graph_feats``,
equal arrays), the embedding bags (``repro_torch.sparse.embedding_bag``,
offsets and fixed-length forms, three modes, padding ids; the row-sharded
lookup on 2x2 meshes of the host against a plain gather), and the GNN
example's configuration trained through the port on the host."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.graphs import rmat_graph as jax_rmat_graph  # noqa: E402
from repro.graphs import sampler as jsampler  # noqa: E402
from repro.sparse.embedding_bag import (  # noqa: E402
    embedding_bag as jax_embedding_bag,
)
from repro_torch import prng  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.graphs.sampler import (  # noqa: E402
    neighbor_sampler, sample_blocks,
)
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.sparse.embedding_bag import (  # noqa: E402
    embedding_bag, row_shards, sharded_embedding_lookup,
)

from _gnn_ref import close, t  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _graphs(n, m, seed=0):
    jg = jax_rmat_graph(n, m, seed=seed)
    g = generators.rmat_graph(n, m, seed=seed)
    assert np.array_equal(g.dst_offsets.numpy(), np.asarray(jg.dst_offsets))
    assert np.array_equal(g.in_src.numpy(), np.asarray(jg.in_src))
    return jg, g


# --------------------------------------------------------------- sampler ----

@pytest.mark.parametrize("n,m,fanout", [(64, 256, 5), (512, 4096, 25)])
def test_neighbor_sampler_ids_equal_jax(n, m, fanout):
    jg, g = _graphs(n, m)
    seeds = np.arange(n, dtype=np.int32)[::-1].copy()
    for s in range(3):
        key = jax.random.PRNGKey(s)
        want = np.asarray(jsampler.neighbor_sampler(
            key, jg.dst_offsets, jg.in_src, seeds, fanout))
        got = neighbor_sampler(np.asarray(key), g.dst_offsets, g.in_src,
                               torch.from_numpy(seeds), fanout)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


def test_neighbor_sampler_isolated_nodes_give_the_sentinel():
    _, g = _graphs(64, 256)
    indeg = np.diff(g.dst_offsets.numpy())
    assert (indeg == 0).any()
    seeds = torch.arange(64, dtype=torch.int32)
    nbrs = neighbor_sampler(prng.PRNGKey(0), g.dst_offsets, g.in_src, seeds,
                            5).numpy()
    for s in range(64):
        lo, hi = g.dst_offsets[s].item(), g.dst_offsets[s + 1].item()
        if indeg[s] == 0:
            assert (nbrs[s] == 64).all()
        else:
            assert set(nbrs[s].tolist()) <= set(
                g.in_src[lo:hi].tolist())


def test_sample_blocks_equal_jax_sentinel_seeds_included():
    """Two hops (the second from a frontier holding the sentinel ``n``,
    which samples the sentinel again, as the reference's clamped read
    gives it)."""
    jg, g = _graphs(64, 256)
    seeds = np.array([0, 5, 17, 63, 40, 2], np.int32)
    key = jax.random.PRNGKey(7)
    want = jsampler.sample_blocks(key, jg.dst_offsets, jg.in_src,
                                  jnp.asarray(seeds), (10, 5))
    got = sample_blocks(np.asarray(key), g.dst_offsets, g.in_src,
                        torch.from_numpy(seeds), (10, 5))
    assert len(got) == len(want) == 2
    for (f, nb), (jf, jnb) in zip(got, want):
        assert np.array_equal(f.numpy(), np.asarray(jf))
        assert np.array_equal(nb.numpy(), np.asarray(jnb))
    assert (got[0][1] == 64).any()
    sentinel = got[1][0] == 64
    assert bool((got[1][1][sentinel] == 64).all())


# -------------------------------------------------- data: graph features ----

def test_synthetic_node_features_equal_the_reference():
    from repro.data.graph_feats import synthetic_node_features as jfeats
    from repro_torch.data import synthetic_node_features

    for kw in ({}, {"seed": 3, "noise": 1.5}):
        f, lab = synthetic_node_features(200, 12, 5, **kw)
        jf, jlab = jfeats(200, 12, 5, **kw)
        assert f.dtype == jf.dtype and lab.dtype == jlab.dtype
        assert np.array_equal(f, jf) and np.array_equal(lab, jlab)


# --------------------------------------------------------- embedding bag ----

@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_fixed_length_matches_jax(mode):
    rng = np.random.default_rng(5)
    table = rng.normal(size=(10, 3)).astype(np.float32)
    idx = rng.integers(0, 10, (6, 4)).astype(np.int32)
    idx[0, :2] = 10                   # padding ids contribute zero
    idx[1] = (10, -1, 10, 12)         # a bag of padding only
    got = embedding_bag(*t(table, idx), mode=mode)
    close(got, jax_embedding_bag(table, idx, mode=mode), 1e-6)
    assert bool((got[1] == 0).all())


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_offsets_match_jax(mode):
    rng = np.random.default_rng(6)
    table = rng.normal(size=(8, 2)).astype(np.float32)
    indices = np.array([0, 1, 2, 5, 8, 3, 3, 7, 8], np.int32)
    # bags: [0, 2), [2, 5), an empty bag at 5, [5, 9)
    offsets = np.array([0, 2, 5, 5], np.int32)
    got = embedding_bag(*t(table, indices, offsets), mode=mode)
    close(got, jax_embedding_bag(table, indices, offsets, mode=mode), 1e-6)
    assert bool((got[2] == 0).all())


@pytest.mark.parametrize("axis", ["model", ("data", "model")])
def test_sharded_embedding_lookup_equals_take(axis):
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
    ids = torch.tensor([[0, 3], [15, 7], [8, 4]])
    mesh = Mesh([["cpu"] * 2] * 2, ("data", "model"))
    shards = 4 if isinstance(axis, tuple) else 2
    tiles = row_shards(mesh, table, axis)
    assert tiles[0, 0].shape == (16 // shards, 4)
    out = sharded_embedding_lookup(tiles, ids, mesh=mesh, axis_name=axis,
                                   shard_rows=16 // shards)
    for c in np.ndindex(*out.shape):
        assert torch.equal(out[c], table[ids])
    with pytest.raises(ValueError, match="shards"):
        row_shards(Mesh([["cpu"] * 3], ("data", "model")), table, "model")


# ------------------------------------------------- the example's config ----

def test_example_configuration_learns_on_the_host():
    """``examples/gnn_node_classification.py``'s setup through the port
    (the smoke's ``sage_example``, here on the host): the mean minibatch
    accuracy of the last 10 steps beats the first 10's by more than
    0.1."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    res = chip_smoke.sage_example(torch, "cpu")
    assert res["acc_last10"] > res["acc_first10"] + 0.1, res
