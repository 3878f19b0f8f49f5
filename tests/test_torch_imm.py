"""repro_torch's imm() end to end against the JAX package's on the CPU:
seeds, theta, rounds, coverage, counter and arena identical; influences;
and a JAX snapshot carried across and extended in the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import IMMConfig as JConfig  # noqa: E402
from repro.core.engine import InfluenceEngine as JEngine  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch import convert, obs  # noqa: E402
from repro_torch.core.engine import IMMConfig, InfluenceEngine  # noqa: E402
from repro_torch.core.imm import imm  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402

SEED_SETS = [[1, 2, 3], [5], [0, 7, 9, 11, 13], list(range(0, 200, 9))]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(cls, method, max_theta, k=5):
    return cls(k=k, backend="sparse", store="bitmap", max_theta=max_theta,
               selection_method=method, seed=3)


@pytest.mark.parametrize("n,m,max_theta", [(256, 1024, 1024),
                                           (512, 2048, 2048)])
@pytest.mark.parametrize("method", ["rebuild", "fused-rebuild",
                                    "fused-decrement"])
def test_imm_matches_jax(n, m, max_theta, method):
    jeng = JEngine(jgen.rmat_graph(n, m, seed=0),
                   _cfg(JConfig, method, max_theta))
    want = jeng.run()
    eng = InfluenceEngine(generators.rmat_graph(n, m, seed=0),
                          _cfg(IMMConfig, method, max_theta), device="cpu")
    got = eng.run()
    np.testing.assert_array_equal(got.seeds, want.seeds)
    assert (got.theta, got.rounds) == (want.theta, want.rounds)
    assert got.covered_frac == want.covered_frac
    assert got.influence == want.influence
    assert got.representation == want.representation == "bitmap"
    np.testing.assert_array_equal(got.counter, want.counter)
    np.testing.assert_array_equal(eng.store.R.numpy(),
                                  np.asarray(jeng.store.R))
    np.testing.assert_array_equal(eng.store.sizes.numpy(),
                                  np.asarray(jeng.store.sizes))
    np.testing.assert_array_equal(eng.influences(SEED_SETS),
                                  jeng.influences(SEED_SETS))
    assert eng.influence(got.seeds) == got.influence


def test_imm_wrapper_and_selections_match_jax():
    g = generators.rmat_graph(256, 1024, seed=1)
    res = imm(g, _cfg(IMMConfig, "rebuild", 512), device="cpu")
    jeng = JEngine(jgen.rmat_graph(256, 1024, seed=1),
                   _cfg(JConfig, "rebuild", 512))
    jres = jeng.run()
    np.testing.assert_array_equal(res.seeds, jres.seeds)
    eng = InfluenceEngine(g, _cfg(IMMConfig, "rebuild", 512), device="cpu")
    eng.run()
    for method in ("rebuild", "decrement", "fused-rebuild",
                   "fused-decrement"):
        for k in (1, 8):
            sel, jsel = eng.select(k, method=method), jeng.select(k,
                                                                  method=method)
            np.testing.assert_array_equal(sel.seeds, jsel.seeds)
            np.testing.assert_array_equal(sel.gains, jsel.gains)
            assert sel.covered_frac == jsel.covered_frac


def test_jax_snapshot_continues_in_the_port():
    n, m, theta1, theta2 = 384, 1536, 512, 1280
    jg = jgen.rmat_graph(n, m, seed=4)
    jeng = JEngine(jg, _cfg(JConfig, "rebuild", 4096))
    jeng.extend(theta1)
    tree = jeng.snapshot_tree()
    tree = {"store": {k: np.asarray(v) for k, v in tree["store"].items()},
            "key": np.asarray(tree["key"]),
            "meta": {k: np.asarray(v) for k, v in tree["meta"].items()}}
    jeng.extend(theta2)

    arrays = {f: np.asarray(getattr(jg, f)) for f in
              ("n", "m", "src_offsets", "out_dst", "dst_offsets", "in_src",
               "in_prob", "in_lt_cum", "in_lt_total", "edge_src",
               "edge_dst")}
    eng = InfluenceEngine(convert.graph_from_arrays(arrays),
                          _cfg(IMMConfig, "rebuild", 4096), device="cpu")
    eng.restore_tree(convert.engine_state_from_tree(tree))
    assert eng.theta == theta1
    eng.extend(theta2)
    assert eng.theta == jeng.theta
    np.testing.assert_array_equal(eng.store.R.numpy(),
                                  np.asarray(jeng.store.R))
    np.testing.assert_array_equal(eng.store.counter.numpy(),
                                  np.asarray(jeng.store.counter))
    np.testing.assert_array_equal(eng.key, np.asarray(jeng.key))
    np.testing.assert_array_equal(eng.select(6).seeds, jeng.select(6).seeds)
    back = eng.snapshot_tree()
    np.testing.assert_array_equal(back["store"]["R"],
                                  np.asarray(jeng.snapshot_tree()["store"]["R"]))


def test_obs_changes_no_result():
    g = generators.rmat_graph(256, 1024, seed=2)
    off = imm(g, _cfg(IMMConfig, "fused-rebuild", 512), device="cpu")
    obs.reset()
    obs.enable()
    try:
        on = imm(g, _cfg(IMMConfig, "fused-rebuild", 512), device="cpu")
        snap = obs.snapshot()
        names = {e["name"] for e in obs.chrome_trace()["traceEvents"]}
    finally:
        obs.reset()
    np.testing.assert_array_equal(on.seeds, off.seeds)
    assert on.covered_frac == off.covered_frac
    assert snap["counters"]["engine.batches_sampled"] == 2
    assert snap["counters"][
        "kernels.dispatch{impl=reference,kernel=arena_commit}"] == 2
    assert {"run", "extend", "sample", "store.write", "select"} <= names


def test_unfused_write_path_matches_fused():
    """``fused_pipeline="off"`` (sampler counter + `add_batch`) stores the
    same rows, counter and sizes as the fused `arena_commit` chain."""
    g = generators.rmat_graph(256, 1024, seed=5)
    engines = []
    for mode in ("auto", "off"):
        cfg = _cfg(IMMConfig, "rebuild", 512)
        cfg.fused_pipeline = mode
        eng = InfluenceEngine(g, cfg, device="cpu")
        eng.run()
        engines.append(eng)
    fused, plain = (e.store for e in engines)
    assert torch.equal(fused.R, plain.R)
    assert torch.equal(fused.counter, plain.counter)
    assert torch.equal(fused.sizes, plain.sizes)


def test_unported_configurations_raise():
    from repro_torch.mesh import Mesh
    g = generators.rmat_graph(256, 1024, seed=0)
    # the sharded store is ported (A8): it needs a mesh, as in the
    # reference, and a mesh takes no index-list arena
    with pytest.raises(ValueError, match="needs a mesh"):
        InfluenceEngine(g, IMMConfig(store="sharded"), device="cpu")
    with pytest.raises(ValueError, match="indices"):
        InfluenceEngine(g, IMMConfig(store="indices"),
                        mesh=Mesh(["cpu"], ("data",)))
    # the LT walk is ported (A4): an LT engine binds the walk
    assert InfluenceEngine(g, IMMConfig(model="LT"), device="cpu"
                           ).sampler_name == "LT/walk"
