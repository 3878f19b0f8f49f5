"""The C4 index-list path of repro_torch against the JAX package on the
CPU, bitwise: bitmap <-> index-list conversion (truncation included),
the sparse scatters, index-list selection (rebuild and decrement, with
ties), the IndexStore, every store's index view, the engine with native
index emission, the C4 chooser over the bitmap, packed and compressed
stores, and emission dropped after a restore across store kinds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import adaptive as jadaptive  # noqa: E402
from repro.core import selection as jselection  # noqa: E402
from repro.core import store as jstore  # noqa: E402
from repro.core.engine import IMMConfig as JConfig  # noqa: E402
from repro.core.engine import InfluenceEngine as JEngine  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.sparse import scatter as jscatter  # noqa: E402
from repro.sparse import segment as jsegment  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import adaptive, selection  # noqa: E402
from repro_torch.core.engine import IMMConfig, InfluenceEngine  # noqa: E402
from repro_torch.core.store import (  # noqa: E402
    BitmapStore, IndexStore, make_store, store_from_state,
)
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.sparse import scatter, segment  # noqa: E402

SEED_SETS = [[1, 2, 3], [5], [0, 7, 9, 11, 13], list(range(0, 90, 9))]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rows(rng, theta, n, density):
    return (rng.random((theta, n)) < density).astype(np.uint8)


# ------------------------------------------------------------ conversion --

@pytest.mark.parametrize("theta,n,density,l_max", [
    (40, 300, 0.02, 16),        # random, sparse
    (40, 300, 0.3, 16),         # longer than l_max: truncated
    (9, 17, 0.0, 4),            # empty rows
    (9, 17, 1.0, 17),           # full rows at l_max == n
    (9, 17, 1.0, 8),            # full rows, truncated
    (64, 511, 0.05, 64),
])
def test_bitmap_to_indices_matches_jax(theta, n, density, l_max):
    R = _rows(np.random.default_rng(theta + n), theta, n, density)
    want = np.array(jadaptive.bitmap_to_indices(jnp.asarray(R), l_max))
    got = adaptive.bitmap_to_indices(torch.from_numpy(R), l_max)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # a small block size walks the rows in several blocks, same bits
    old = adaptive.CONVERT_BLOCK_ELEMS
    adaptive.CONVERT_BLOCK_ELEMS = 2 * n
    try:
        blocked = adaptive.bitmap_to_indices(torch.from_numpy(R), l_max)
    finally:
        adaptive.CONVERT_BLOCK_ELEMS = old
    np.testing.assert_array_equal(blocked.numpy(), want)
    np.testing.assert_array_equal(
        adaptive.indices_to_bitmap(got, n).numpy(),
        np.asarray(jadaptive.indices_to_bitmap(jnp.asarray(want), n)))
    for rep, arr in (("bitmap", R), ("indices", want)):
        np.testing.assert_array_equal(
            adaptive.set_sizes(torch.from_numpy(arr), rep, n).numpy(),
            np.asarray(jadaptive.set_sizes(jnp.asarray(arr), rep, n)))


def test_l_pad_and_chooser_match_jax():
    for l_max in (0, 1, 3, 4, 5, 100, 128, 129, 70000):
        assert adaptive.l_pad_for(l_max) == jadaptive.l_pad_for(l_max)
    for cov, n, l_max, ratio in ((0.01, 1000, 10, 32), (0.05, 1000, 10, 32),
                                 (0.001, 1000, 40, 32), (0.5, 10, 1, 1)):
        assert adaptive.choose_representation(cov, n, l_max, ratio) == \
            jadaptive.choose_representation(cov, n, l_max, ratio)


# -------------------------------------------------------------- scatters --

def test_bincount_weighted_drops_sentinels_like_jax():
    rng = np.random.default_rng(0)
    n = 50
    idx = rng.integers(0, n + 1, (33, 8)).astype(np.int32)   # sentinel n
    idx[:, -3:] = n
    for w in (np.ones((33, 1), np.float32),
              rng.integers(0, 4, (33, 1)).astype(np.float32),
              rng.integers(0, 4, (33, 1)).astype(np.int32)):
        want = np.asarray(jscatter.bincount_weighted(
            jnp.asarray(idx), jnp.asarray(w), n))
        got = scatter.bincount_weighted(torch.from_numpy(idx),
                                        torch.from_numpy(w), n)
        assert got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            scatter.one_hot_matmul_count(torch.from_numpy(idx),
                                         torch.from_numpy(w), n).numpy(),
            np.asarray(jscatter.one_hot_matmul_count(
                jnp.asarray(idx), jnp.asarray(w), n)))


def test_scatter_and_segment_ops_match_jax():
    rng = np.random.default_rng(1)
    target = rng.integers(0, 5, 7).astype(np.int32)
    idx = np.array([-1, 9, 2, -8, 2, 6, 0], np.int32)    # wrap and drop
    upd = rng.integers(0, 9, 7).astype(np.int32)
    for t, j in ((scatter.scatter_add, jscatter.scatter_add),
                 (scatter.scatter_or, jscatter.scatter_or)):
        np.testing.assert_array_equal(
            t(torch.from_numpy(target), torch.from_numpy(idx),
              torch.from_numpy(upd)).numpy(),
            np.asarray(j(jnp.asarray(target), jnp.asarray(idx),
                         jnp.asarray(upd))))
    data = rng.integers(-4, 5, (40, 3)).astype(np.float32)
    ids = rng.integers(-2, 9, 40).astype(np.int32)        # out of range too
    for name in ("segment_sum", "sorted_segment_sum", "segment_max",
                 "segment_mean"):
        np.testing.assert_array_equal(
            getattr(segment, name)(torch.from_numpy(data),
                                   torch.from_numpy(ids), 7).numpy(),
            np.asarray(getattr(jsegment, name)(jnp.asarray(data),
                                               jnp.asarray(ids), 7)))
    iv = data.astype(np.int32)
    np.testing.assert_array_equal(
        segment.segment_max(torch.from_numpy(iv), torch.from_numpy(ids),
                            7).numpy(),
        np.asarray(jsegment.segment_max(jnp.asarray(iv), jnp.asarray(ids),
                                        7)))
    logits = rng.standard_normal(40).astype(np.float32)
    np.testing.assert_allclose(
        segment.segment_softmax(torch.from_numpy(logits),
                                torch.from_numpy(ids), 7).numpy(),
        np.asarray(jsegment.segment_softmax(jnp.asarray(logits),
                                            jnp.asarray(ids), 7)),
        rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- selection --

def _index_arena(seed, theta=256, n=120, density=0.04):
    rng = np.random.default_rng(seed)
    R = _rows(rng, theta, n, density)
    R[:, 7] |= (rng.random(theta) < 0.3).astype(np.uint8)   # a hub
    l_pad = adaptive.l_pad_for(int(R.sum(1).max()))
    R_idx = np.array(jadaptive.bitmap_to_indices(jnp.asarray(R), l_pad))
    valid = rng.random(theta) < 0.9
    return R, R_idx, valid


@pytest.mark.parametrize("method", ["rebuild", "decrement"])
@pytest.mark.parametrize("case", ["random", "ties", "k_past_cover",
                                  "no_valid"])
def test_select_sparse_matches_jax(method, case):
    R, R_idx, valid = _index_arena(3)
    n, k = R.shape[1], 6
    if case == "ties":
        # two identical hub columns: the first maximum wins every round
        R = R.copy()
        R[:, 40] = R[:, 7]
        R_idx = np.asarray(jadaptive.bitmap_to_indices(
            jnp.asarray(R), R_idx.shape[1] * 2))
    elif case == "k_past_cover":
        k = 60
    elif case == "no_valid":
        valid = np.zeros_like(valid)
    want = jselection.select_sparse(jnp.asarray(R_idx), jnp.asarray(valid),
                                    n, k, method)
    got = selection.select_sparse(torch.from_numpy(R_idx),
                                  torch.from_numpy(valid), n, k, method)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert float(got[1]) == float(want[1])
    assert got[1].dtype == torch.float32
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if case == "ties":
        assert 40 not in got[0].tolist()
    # and the bitmap strategies on the same sets agree
    R_bit = adaptive.indices_to_bitmap(torch.from_numpy(R_idx), n)
    dense = selection.greedy_select(R_bit, torch.from_numpy(valid), k,
                                    method=method)
    sparse = selection.greedy_select(torch.from_numpy(R_idx),
                                     torch.from_numpy(valid), k, n=n,
                                     representation="indices",
                                     method=method)
    for a, b in zip(dense, sparse):
        assert torch.equal(a, b)


def test_sparse_strategies_are_registered():
    for method in ("rebuild", "decrement", "fused-rebuild",
                   "fused-decrement"):
        assert selection.get_selection(method, "sparse") is not None
    # the sharded layouts are ported (A8)
    assert selection.get_selection("rebuild", "sharded-sparse") is not None
    with pytest.raises(ValueError):
        selection.greedy_select(None, None, 1, representation="csr")


# ------------------------------------------------------------ IndexStore --

def _same_store(got, want):
    assert (got.count, got.capacity, got.l_pad) == (want.count,
                                                    want.capacity,
                                                    want.l_pad)
    np.testing.assert_array_equal(got.R.numpy(), np.asarray(want.R))
    np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(want.sizes))
    np.testing.assert_array_equal(got.counter.numpy(),
                                  np.asarray(want.counter))


def test_index_store_matches_jax():
    """add_batch / add_index_batch, widening (a batch with a larger set,
    an emitted batch wider than the arena), growth past the capacity,
    hits, state and its round trip."""
    rng = np.random.default_rng(5)
    n = 200
    st = make_store("indices", n, device="cpu")
    assert isinstance(st, IndexStore) and st.l_pad == 4
    jst = jstore.make_store("indices", n)
    batches = [_rows(rng, 10, n, 0.01), _rows(rng, 12, n, 0.08),
               _rows(rng, 3, n, 0.0)]
    for b in batches:
        slots = st.add_batch(torch.from_numpy(b))
        jslots = jst.add_batch(jnp.asarray(b))
        np.testing.assert_array_equal(slots, jslots)
        _same_store(st, jst)
    # native rows: narrower than the arena, wider, with emitter sentinels
    for L, dens in ((8, 0.01), (64, 0.25)):
        b = _rows(rng, 9, n, dens)
        rows = np.asarray(jadaptive.bitmap_to_indices(jnp.asarray(b), L))
        rows = np.where(rows == n, n + 5, rows).astype(np.int32)
        counter = b.sum(0).astype(np.int32)
        for c in (None, counter):
            st.add_index_batch(
                torch.from_numpy(rows),
                None if c is None else torch.from_numpy(c))
            jst.add_index_batch(jnp.asarray(rows),
                                None if c is None else jnp.asarray(c))
            _same_store(st, jst)
    assert st.capacity == 64 and st.l_pad == 64
    assert st.arena_bytes == 64 * 64 * 4
    S = np.array([[1, 2, 3, 3], [7, 7, 7, 7], [0, 50, 199, 10],
                  [n, n, n, n]], np.int32)
    np.testing.assert_array_equal(st.hits(S).numpy(),
                                  np.asarray(jst.hits(S)))
    state = st.state()
    jstate = jst.state()
    for key in ("n", "count", "R", "sizes", "counter", "live", "kind"):
        np.testing.assert_array_equal(np.asarray(state[key]),
                                      np.asarray(jstate[key]))
    back = store_from_state(state, device="cpu")
    assert isinstance(back, IndexStore)
    _same_store(back, jst)
    assert not np.shares_memory(back.R.numpy(), state["R"])
    back.add_index_batch(torch.full((2, 4), n, dtype=torch.int32))
    assert back.count == st.count + 2
    np.testing.assert_array_equal(
        store_from_state({k: np.asarray(v) for k, v in jstate.items()},
                         device="cpu").R.numpy(), np.asarray(jst.R))
    for bad in ("bitmap", "packed"):
        with pytest.raises(ValueError, match="indices"):
            store_from_state(state, kind=bad, device="cpu")
    bitmap = BitmapStore(n, device="cpu")
    bitmap.add_batch(torch.from_numpy(batches[0]))
    with pytest.raises(ValueError, match="indices"):
        store_from_state(bitmap.state(), kind="indices", device="cpu")


@pytest.mark.parametrize("kind", ["bitmap", "packed", "compressed"])
def test_index_views_match_jax(kind):
    rng = np.random.default_rng(6)
    n = 150
    st = make_store(kind, n, device="cpu")
    jst = jstore.make_store(kind, n)
    for density in (0.02, 0.1):
        b = _rows(rng, 20, n, density)
        st.add_batch(torch.from_numpy(b))
        jst.add_batch(jnp.asarray(b))
    for l_pad in (4, 32):
        v, jv = st.index_view(l_pad), jst.index_view(l_pad)
        assert v.representation == jv.representation == "indices"
        np.testing.assert_array_equal(v.R.numpy(), np.asarray(jv.R))
        np.testing.assert_array_equal(v.valid.numpy(), np.asarray(jv.valid))
        assert st.index_view(l_pad).R is v.R          # cached
    st.add_batch(torch.from_numpy(_rows(rng, 4, n, 0.05)))
    assert st.index_view(32).R is not v.R            # a write drops it


# --------------------------------------------------------------- engines --

def _engines(store, graph, **kw):
    cfg = dict(k=4, seed=1, **kw)
    jgraph, tgraph = graph
    return (JEngine(jgraph, JConfig(store=store, **cfg)),
            InfluenceEngine(tgraph, IMMConfig(store=store, **cfg),
                            device="cpu"))


GRAPHS = {
    "path": (lambda: (jgen.path_graph(512, p=0.5),
                      generators.path_graph(512, p=0.5)),
             dict(batch=64, max_theta=256)),
    "rmat": (lambda: (jgen.rmat_graph(100, 3000, seed=0),
                      generators.rmat_graph(100, 3000, seed=0)),
             dict(batch=16, max_theta=128)),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_native_emission_matches_jax_and_the_bitmap_engine(graph):
    """IndexStore + the sparse sampler: rows emitted as lists, the width
    doubling and capping at n (not its next power of two), counters and
    seeds equal to the bitmap engine's and to JAX's."""
    make, kw = GRAPHS[graph]
    g = make()
    kw = dict(kw, backend="sparse")
    jeng, eng = _engines("indices", g, **kw)
    assert eng._emit_l == jeng._emit_l == 4
    assert eng._fused is None
    obs.reset()
    obs.enable()
    try:
        res = eng.run()
        reemits = obs.snapshot()["counters"].get("engine.index_reemits", 0)
    finally:
        obs.reset()
    jres = jeng.run()
    assert eng._emit_l == jeng._emit_l
    assert reemits > 0
    if graph == "rmat":
        assert eng._emit_l == g[1].n       # full rows: capped at n = 100
        assert eng.store.l_pad == 128
    np.testing.assert_array_equal(res.seeds, jres.seeds)
    assert (res.theta, res.rounds, res.covered_frac) == (
        jres.theta, jres.rounds, jres.covered_frac)
    assert res.representation == "indices"
    np.testing.assert_array_equal(res.counter, jres.counter)
    np.testing.assert_array_equal(eng.store.R.numpy(),
                                  np.asarray(jeng.store.R))
    np.testing.assert_array_equal(eng.influences(SEED_SETS),
                                  jeng.influences(SEED_SETS))
    for method in ("decrement", "fused-rebuild", "fused-decrement"):
        np.testing.assert_array_equal(eng.select(4, method=method).seeds,
                                      res.seeds)
    _, bit = _engines("bitmap", g, **kw)
    bres = bit.run()
    np.testing.assert_array_equal(bres.seeds, res.seeds)
    np.testing.assert_array_equal(bres.counter, res.counter)
    assert bres.covered_frac == res.covered_frac
    np.testing.assert_array_equal(
        adaptive.bitmap_to_indices(bit.store.R, eng.store.l_pad).numpy(),
        eng.store.R.numpy())


def test_index_store_without_emission_converts_on_write():
    """The dense sampler has no emission: an IndexStore converts its
    bitmap batches on write, bitwise the port's bitmap engine (the
    dense path is bitwise within the port) and the reference's rows."""
    make, kw = GRAPHS["path"]
    g = make()
    jeng, eng = _engines("indices", g, **kw)
    _, bit = _engines("bitmap", g, **kw)
    assert eng.sampler_name == "IC/dense" and eng._emit_l == 0
    res, bres = eng.run(), bit.run()
    np.testing.assert_array_equal(res.seeds, bres.seeds)
    np.testing.assert_array_equal(res.counter, bres.counter)
    np.testing.assert_array_equal(
        adaptive.bitmap_to_indices(bit.store.R, eng.store.l_pad).numpy(),
        eng.store.R.numpy())
    jres = jeng.run()
    assert jres.representation == res.representation == "indices"


@pytest.mark.parametrize("store", ["bitmap", "packed", "compressed"])
def test_forced_c4_picks_indices_and_jax_seeds(store):
    """C4 forced on (``sparse_rep_min_n=1, switch_ratio=1``, as the
    reference's pack tests force it): selection reads the store's index
    view, representation ``"indices"``, seeds equal to JAX's and to the
    store's own layout's."""
    jg, g = jgen.rmat_graph(128, 256, seed=1), \
        generators.rmat_graph(128, 256, seed=1)
    cfg = dict(k=5, batch=64, max_theta=256, seed=3, store=store,
               backend="sparse", adaptive_representation=True,
               sparse_rep_min_n=1, switch_ratio=1)
    jres = JEngine(jg, JConfig(**cfg)).run()
    eng = InfluenceEngine(g, IMMConfig(**cfg), device="cpu")
    res = eng.run()
    assert res.representation == jres.representation == "indices"
    np.testing.assert_array_equal(res.seeds, jres.seeds)
    assert res.covered_frac == jres.covered_frac
    np.testing.assert_array_equal(res.counter, jres.counter)
    for method in ("fused-rebuild", "decrement"):
        sel = eng.select(5, method=method)
        assert sel.representation == "indices"
        np.testing.assert_array_equal(sel.seeds, res.seeds)
    off = InfluenceEngine(g, IMMConfig(**dict(
        cfg, adaptive_representation=False)), device="cpu").run()
    assert off.representation == store
    np.testing.assert_array_equal(off.seeds, res.seeds)


def test_restore_across_store_kinds_resets_index_emission(tmp_path):
    """An indices-configured engine restoring a bitmap snapshot keeps the
    bitmap store and drops index emission, as the reference does."""
    make, kw = GRAPHS["rmat"]
    jg, g = make()
    cfg = dict(k=4, seed=1, backend="sparse", **kw)
    src = InfluenceEngine(g, IMMConfig(store="bitmap", **cfg), device="cpu")
    src.extend(32)
    src.snapshot(str(tmp_path))
    idx = InfluenceEngine(g, IMMConfig(store="indices", **cfg), device="cpu")
    assert idx._emit_l > 0
    assert idx.restore(str(tmp_path))
    assert isinstance(idx.store, BitmapStore) and idx._emit_l == 0
    assert idx._fused is not None
    idx.extend(64)
    src.extend(64)
    assert torch.equal(idx.store.counter, src.store.counter)
    jidx = JEngine(jg, JConfig(store="indices", **cfg))
    assert jidx.restore(str(tmp_path)) and jidx._emit_l == 0
    jidx.extend(64)
    np.testing.assert_array_equal(np.asarray(jidx.store.counter),
                                  idx.store.counter.numpy())
    # and back: an index snapshot restores into an indices engine
    idx2 = InfluenceEngine(g, IMMConfig(store="indices", **cfg),
                           device="cpu")
    idx2.extend(32)
    idx2.snapshot(str(tmp_path), tag="idx")
    fresh = InfluenceEngine(g, IMMConfig(store="indices", **cfg),
                            device="cpu")
    assert fresh.restore(str(tmp_path), tag="idx")
    assert fresh._emit_l == fresh.store.l_pad
    packed = InfluenceEngine(g, IMMConfig(store="packed", **cfg),
                             device="cpu")
    with pytest.raises(ValueError, match="indices"):
        packed.restore(str(tmp_path), tag="idx")
