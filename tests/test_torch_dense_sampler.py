"""The port's dense and pallas samplers against the JAX package's on the
CPU: logq tables correctly rounded and within two ulp of JAX's, roots
exact, activations equal up to
near-ties (each differing row traced to its first differing BFS step by
bisecting on max_steps, then classified), dense == pallas in the port up
to near-ties, and the engine: IMMConfig() on a small graph runs IC/dense,
and selection on a restored JAX dense-solve snapshot is exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import sampler as jsampler  # noqa: E402
from repro.core.engine import IMMConfig as JConfig  # noqa: E402
from repro.core.engine import InfluenceEngine as JEngine  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core import sampler, ties  # noqa: E402
from repro_torch.core.engine import IMMConfig, InfluenceEngine  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _graphs(n, m, seed):
    return jgen.rmat_graph(n, m, seed=seed), generators.rmat_graph(
        n, m, seed=seed)


def _logqs(model, jg, g):
    jl = jsampler.logq_from_probs(jg, jsampler.get_model(model).edge_probs(jg))
    pl = sampler.logq_from_probs(g, sampler._edge_probs(
        sampler.get_model(model), g))
    return np.asarray(jl), pl


def _ulps(a, b):
    """Distance in float32 steps between same-signed float32 arrays."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("model", ["IC", "WC", "GT"])
def test_logq_is_correctly_rounded_and_near_jax(model):
    """The port's table is log1p(-p) in float64 rounded once to float32
    (0.5 ulp from the true value); JAX's f32 log1p is off by up to ~1.5
    ulp, so the two differ by at most 2 ulp, in about a tenth of the
    entries (counts printed)."""
    jg, g = _graphs(384, 3072, 4)
    jl, pl = _logqs(model, jg, g)
    pl = pl.numpy()
    assert pl.dtype == np.float32 and pl.shape == (384, 384)
    P = jsampler.dense_ic_matrix(jg, jsampler.get_model(model).edge_probs(jg))
    with np.errstate(divide="ignore"):
        true = np.log1p(-np.asarray(P, np.float64).T)
    nz = P.T != 0
    np.testing.assert_array_equal(pl != 0, nz)
    free = nz & (true > -30.0)           # entries above the clamp
    assert (pl[nz & ~free] == -30.0).all()
    err = np.abs(pl[free] - true[free]) / np.spacing(np.abs(pl[free]))
    assert err.max() <= 0.5
    ulps = _ulps(pl, jl)
    print(f"{model}: of {int(nz.sum())} nonzero logq entries "
          f"{int((ulps == 1).sum())} differ from JAX's by 1 ulp and "
          f"{int((ulps == 2).sum())} by 2")
    assert ulps.max() <= 2


def _compare(model, backend, stable, *, n=256, m=2048, seed=1, batch=48,
             positions=None):
    """Run the JAX and the port dense loop on one key and classify every
    differing row; returns the report (roots checked exact)."""
    jg, g = _graphs(n, m, seed)
    jl, pl = _logqs(model, jg, g)
    key = prng.split(prng.PRNGKey(seed + 5), 2)[1]
    kernel = backend == "pallas"
    jpos = None if positions is None else jnp.asarray(positions, jnp.int32)

    def run_ref(t):
        return np.asarray(jsampler._dense_loop(
            jnp.asarray(key), jnp.asarray(jl), jpos, batch=batch,
            max_steps=t, stable=stable, kernel=kernel)[0])

    def run_port(t):
        return sampler._dense_loop(key, pl, positions, batch=batch,
                                   max_steps=t, stable=stable,
                                   kernel=kernel)[0].numpy()

    jv, jc, jr = jsampler._dense_loop(jnp.asarray(key), jnp.asarray(jl), jpos,
                                      batch=batch, stable=stable,
                                      kernel=kernel)
    v, c, r = sampler._dense_loop(key, pl, positions, batch=batch,
                                  stable=stable, kernel=kernel)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    assert torch.equal(c, v.sum(0, dtype=torch.int32))

    def coins(t):
        return sampler.dense_coins(key, t, batch=batch, n_nodes=n,
                                   positions=positions,
                                   stable=stable).numpy()

    report = ties.classify_runs(run_ref, run_port, coins, pl.numpy(),
                                r.numpy(), max_steps=n)
    same = (v.numpy() == np.asarray(jv)).all(axis=1)
    assert report["rows"] == int((~same).sum())
    print(f"{model}/{backend}{'+stable' if stable else ''}: "
          f"{report['rows']} of {len(same)} rows differ from JAX, "
          f"{report['cells']} cells at their first step, "
          f"{report['ties']} near-ties")
    assert report["faults"] == []
    return report


@pytest.mark.parametrize("model", ["IC", "WC", "GT"])
@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("stable", [False, True])
def test_dense_loop_matches_jax_up_to_near_ties(model, backend, stable):
    _compare(model, backend, stable)


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_stable_positions_match_jax_up_to_near_ties(backend):
    _compare("IC", backend, True, positions=np.array([40, 3, 17, 3, 0]))


@pytest.mark.parametrize("model", ["IC", "WC", "GT"])
def test_dense_equals_pallas_in_the_port_up_to_near_ties(model):
    g = generators.rmat_graph(320, 2560, seed=6)
    logq = sampler.logq_from_probs(g, sampler._edge_probs(
        sampler.get_model(model), g))
    key = prng.PRNGKey(8)

    def run(kernel):
        return lambda t: sampler._dense_loop(key, logq, batch=64,
                                             max_steps=t,
                                             kernel=kernel)[0].numpy()

    _, _, roots = sampler._dense_loop(key, logq, batch=64)
    report = ties.classify_runs(
        run(True), run(False),
        lambda t: sampler.dense_coins(key, t, batch=64, n_nodes=g.n).numpy(),
        logq.numpy(), roots.numpy(), max_steps=g.n)
    print(f"{model}: dense vs pallas {report}")
    assert report["faults"] == []


def test_classify_runs_traces_a_tie_and_a_fault():
    """Two hand-built trajectories that split at step 2 on one cell: a
    near-tie when the coin sits on p, a fault when it does not."""
    n = 4
    logq = np.full((n, n), -0.0, np.float32)
    logq[1, 2] = np.float32(np.log1p(-0.3))     # edge 2 -> 1, p = 0.3
    logq[0, 1] = np.float32(np.log1p(-0.9))     # edge 1 -> 0
    roots = np.array([0, 3])
    v1 = np.array([[1, 1, 0, 0], [0, 0, 0, 1]], bool)
    v2a = v1.copy()
    v2a[0, 2] = True
    traj = {"a": {1: v1, 2: v2a, 3: v2a}, "b": {1: v1, 2: v1, 3: v1}}
    p = np.float32(-np.expm1(np.float64(logq[1, 2])))
    for coin, tie in ((p, True), (np.float32(0.1), False)):
        rand = np.ones((2, n), np.float32)
        rand[0, 2] = coin
        rep = ties.classify_runs(lambda t: traj["a"][t],
                                 lambda t: traj["b"][t],
                                 lambda t: rand, logq, roots, max_steps=3)
        assert rep["rows"] == 1 and rep["cells"] == 1 and rep["steps"] == [2]
        assert rep["ties"] == int(tie) and (rep["faults"] == []) == tie


# ---------------------------------------------------------------- engine ----

def test_default_config_runs_dense_on_small_graphs():
    g = generators.rmat_graph(300, 1800, seed=2)
    assert InfluenceEngine(g, IMMConfig(),
                           device="cpu").sampler_name == "IC/dense"
    eng = InfluenceEngine(g, IMMConfig(k=4, max_theta=512), device="cpu")
    assert eng.sampler_name == "IC/dense"
    res = eng.run()
    assert len(set(res.seeds.tolist())) == 4 and 0 < res.covered_frac <= 1
    assert res.theta == eng.store.count > 0
    np.testing.assert_array_equal(
        res.counter, eng.store.R[:res.theta].sum(0, dtype=torch.int32).numpy())


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_selection_on_a_restored_jax_dense_snapshot_is_exact(backend):
    """Sampling aside, everything is exact: a JAX dense solve's store,
    restored into the port, selects the reference's seeds, gains and
    coverage with every method."""
    n, m = 256, 2048
    jg, g = _graphs(n, m, 9)
    kw = dict(k=6, backend=backend, max_theta=1024, seed=4)
    jeng = JEngine(jg, JConfig(**kw))
    jeng.run()
    tree = jax_tree = jeng.snapshot_tree()
    eng = InfluenceEngine(g, IMMConfig(**kw), device="cpu")
    eng.restore_tree(convert.engine_state_from_tree(
        {"store": {k: np.asarray(v) for k, v in tree["store"].items()},
         "key": np.asarray(jax_tree["key"]), "meta": tree["meta"]}))
    assert eng.theta == jeng.theta
    for method in ("rebuild", "decrement", "fused-rebuild",
                   "fused-decrement"):
        want, got = jeng.select(6, method=method), eng.select(6,
                                                              method=method)
        np.testing.assert_array_equal(got.seeds, want.seeds)
        np.testing.assert_array_equal(got.gains, np.asarray(want.gains))
        assert got.covered_frac == want.covered_frac
