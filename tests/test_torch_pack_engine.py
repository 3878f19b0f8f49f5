"""The port's IMPack stores end to end against the JAX package on the CPU:
imm() on packed and compressed arenas under every selection method —
seeds, theta, coverage, gains, counter, sizes and the at-rest arena
identical to JAX's and to the port's own bitmap solve — and JAX
snapshots of each store carried into port engines of each store."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import IMMConfig as JConfig  # noqa: E402
from repro.core.engine import InfluenceEngine as JEngine  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch import convert, obs  # noqa: E402
from repro_torch.core.engine import IMMConfig, InfluenceEngine  # noqa: E402
from repro_torch.core.store import store_from_state  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402

STORES = ("bitmap", "packed", "compressed")
METHODS = ("rebuild", "decrement", "fused-rebuild", "fused-decrement")
SEED_SETS = [[1, 2, 3], [5], [0, 7, 9, 11, 13], list(range(0, 300, 9))]
N, M, MAX_THETA = 384, 1536, 2048


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(cls, store, method="rebuild", max_theta=MAX_THETA):
    return cls(k=6, backend="sparse", store=store, max_theta=max_theta,
               selection_method=method, seed=7)


def _np_tree(tree):
    return {"store": {k: np.asarray(v) for k, v in tree["store"].items()},
            "key": np.asarray(tree["key"]),
            "meta": {k: np.asarray(v) for k, v in tree["meta"].items()}}


@pytest.fixture(scope="module")
def bitmap_run():
    eng = InfluenceEngine(generators.rmat_graph(N, M, seed=1),
                          _cfg(IMMConfig, "bitmap"), device="cpu")
    return eng.run(), eng


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX solve per encoded store; every method selects the same
    seeds there, and each method's own rounds are held to the JAX
    engine's `select` with that method."""
    runs = {}
    for store in ("packed", "compressed"):
        jeng = JEngine(jgen.rmat_graph(N, M, seed=1), _cfg(JConfig, store))
        runs[store] = (jeng.run(), jeng)
    return runs


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("store", ["packed", "compressed"])
def test_pack_imm_matches_jax_and_bitmap(store, method, bitmap_run,
                                         jax_runs):
    want, jeng = jax_runs[store]
    eng = InfluenceEngine(generators.rmat_graph(N, M, seed=1),
                          _cfg(IMMConfig, store, method), device="cpu")
    got = eng.run()
    np.testing.assert_array_equal(got.seeds, want.seeds)
    assert (got.theta, got.rounds) == (want.theta, want.rounds)
    assert got.covered_frac == want.covered_frac
    assert got.influence == want.influence
    assert got.representation == want.representation == store
    np.testing.assert_array_equal(got.counter, want.counter)
    assert eng.store.R.shape == jeng.store.R.shape
    np.testing.assert_array_equal(eng.store.R.numpy(),
                                  np.asarray(jeng.store.R))
    np.testing.assert_array_equal(eng.store.sizes.numpy(),
                                  np.asarray(jeng.store.sizes))
    np.testing.assert_array_equal(eng.influences(SEED_SETS),
                                  jeng.influences(SEED_SETS))
    for k in (1, 6):
        sel, jsel = eng.select(k, method=method), jeng.select(k, method=method)
        np.testing.assert_array_equal(sel.seeds, jsel.seeds)
        np.testing.assert_array_equal(sel.gains, jsel.gains)
        assert sel.covered_frac == jsel.covered_frac

    bres, beng = bitmap_run
    np.testing.assert_array_equal(got.seeds, bres.seeds)
    assert (got.theta, got.covered_frac) == (bres.theta, bres.covered_frac)
    np.testing.assert_array_equal(got.counter, bres.counter)
    np.testing.assert_array_equal(eng.store.sizes.numpy(),
                                  beng.store.sizes.numpy())
    theta = got.theta
    np.testing.assert_array_equal(
        eng.store.codec.decode(eng.store.R[:theta]).numpy(),
        beng.store.R[:theta].numpy())


@pytest.fixture(scope="module")
def jax_snapshots():
    """A JAX engine of each store stopped at theta 512, as numpy trees."""
    jg = jgen.rmat_graph(N, M, seed=4)
    trees = {}
    for store in STORES:
        jeng = JEngine(jg, _cfg(JConfig, store, max_theta=4096))
        jeng.extend(512)
        trees[store] = _np_tree(jeng.snapshot_tree())
    arrays = {f: np.asarray(getattr(jg, f)) for f in
              ("n", "m", "src_offsets", "out_dst", "dst_offsets", "in_src",
               "in_prob", "in_lt_cum", "in_lt_total", "edge_src",
               "edge_dst")}
    return jg, arrays, trees


@pytest.mark.parametrize("dst", STORES)
@pytest.mark.parametrize("src", STORES)
def test_jax_snapshot_continues_in_each_store(src, dst, jax_snapshots):
    jg, arrays, trees = jax_snapshots
    tree = trees[src]
    jeng = JEngine(jg, _cfg(JConfig, dst, max_theta=4096))
    jeng.restore_tree(tree)
    jeng.extend(1280)

    state = convert.engine_state_from_tree(tree)
    eng = InfluenceEngine(convert.graph_from_arrays(arrays),
                          _cfg(IMMConfig, dst, max_theta=4096), device="cpu")
    eng.restore_tree(state)
    assert eng.theta == 512
    eng.extend(1280)
    assert eng.theta == jeng.theta
    assert eng.store.representation == jeng.store.representation
    np.testing.assert_array_equal(eng.store.R.numpy(),
                                  np.asarray(jeng.store.R))
    np.testing.assert_array_equal(eng.store.counter.numpy(),
                                  np.asarray(jeng.store.counter))
    np.testing.assert_array_equal(eng.store.sizes.numpy(),
                                  np.asarray(jeng.store.sizes))
    np.testing.assert_array_equal(eng.key, np.asarray(jeng.key))
    np.testing.assert_array_equal(eng.select(6).seeds, jeng.select(6).seeds)
    np.testing.assert_array_equal(eng.influences(SEED_SETS),
                                  jeng.influences(SEED_SETS))
    back = eng.snapshot_tree()["store"]
    np.testing.assert_array_equal(
        back["R"], np.asarray(jeng.snapshot_tree()["store"]["R"]))

    # the elastic restore itself: the snapshot's rows in the dst store
    st = state["store"]
    restored = store_from_state(st, kind=dst, device="cpu")
    assert restored.representation == dst and restored.count == 512
    rows = restored.codec.decode(restored.R[:512]) if dst != "bitmap" \
        else restored.R[:512]
    np.testing.assert_array_equal(rows.numpy(),
                                  trees["bitmap"]["store"]["R"][:512])
    np.testing.assert_array_equal(restored.counter.numpy(), st["counter"])


def test_snapshot_rejects_a_mismatched_arena(jax_snapshots):
    tree = dict(jax_snapshots[2]["packed"])
    tree["store"] = dict(tree["store"], R=tree["store"]["R"][:, :-1])
    with pytest.raises(ValueError, match="columns"):
        convert.engine_state_from_tree(tree)


@pytest.mark.parametrize("store", ["packed", "compressed"])
def test_unfused_write_and_obs_gauges(store):
    """``fused_pipeline="off"`` writes the same packed arena as the fused
    ``arena_commit`` chain, each batch again one ``arena_commit`` call
    (through ``add_batch``), and the arena-bytes gauge reports the
    at-rest row width."""
    g = generators.rmat_graph(256, 1024, seed=5)
    key = "kernels.dispatch{impl=reference,kernel=arena_commit_packed}"
    engines, commits = [], []
    obs.reset()
    obs.enable()
    try:
        for mode in ("auto", "off"):
            cfg = _cfg(IMMConfig, store, max_theta=512)
            cfg.fused_pipeline = mode
            eng = InfluenceEngine(g, cfg, device="cpu")
            eng.run()
            engines.append(eng)
            commits.append(obs.snapshot()["counters"].get(key, 0))
        snap = obs.snapshot()
    finally:
        obs.reset()
    fused, plain = (e.store for e in engines)
    assert torch.equal(fused.R, plain.R)
    assert torch.equal(fused.counter, plain.counter)
    assert torch.equal(fused.sizes, plain.sizes)
    width = fused.codec.width * fused.R.element_size()
    assert snap["gauges"]["store.arena_bytes"]["value"] == fused.capacity * width
    assert commits == ([2, 4] if store == "packed" else [0, 0])
