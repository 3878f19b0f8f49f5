"""The LT random walk of repro_torch against the JAX package on the CPU,
bitwise: the walk loop (positional and stable coins, ``positions``
subsets, ``max_steps``), hand-built tables whose search runs off its
segment's end, a root with no in-edge, an edgeless graph, every
registered LT sampler name, imm() under LT, and the graph builders the
walk and the stream rebuild through (``erdos_graph``, ``star_graph``,
``build_graph``'s ``weighted_ic="wc"`` and ``lt_weight``)."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import sampler as jsampler  # noqa: E402
from repro.core.engine import IMMConfig as JConfig  # noqa: E402
from repro.core.imm import imm as jimm  # noqa: E402
from repro.graphs import csr as jcsr  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import sampler  # noqa: E402
from repro_torch.core.engine import IMMConfig  # noqa: E402
from repro_torch.core.imm import imm  # noqa: E402
from repro_torch.graphs import csr, generators  # noqa: E402

GRAPH_FIELDS = ("src_offsets", "out_dst", "dst_offsets", "in_src",
                "in_prob", "in_lt_cum", "in_lt_total", "edge_src",
                "edge_dst")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _same_graph(jg, tg):
    assert (jg.n, jg.m) == (tg.n, tg.m)
    for f in GRAPH_FIELDS:
        a = np.asarray(getattr(jg, f))
        b = getattr(tg, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _tables(g):
    return (g.dst_offsets, g.in_src, g.in_lt_cum, g.in_lt_total)


def _jwalk(tables, seed, positions=None, **kw):
    out = jsampler._walk_loop(
        jax.random.PRNGKey(seed), *(jnp.asarray(t) for t in tables),
        None if positions is None else jnp.asarray(positions, jnp.int32),
        **kw)
    return [np.asarray(x) for x in out]


def _twalk(tables, seed, positions=None, **kw):
    out = sampler._walk_loop(
        prng.PRNGKey(seed), *(torch.from_numpy(np.array(t))
                              for t in tables), positions, **kw)
    return [x.numpy() for x in out]


def _assert_walks_equal(want, got):
    for a, b in zip(want, got):
        assert a.shape == b.shape and np.array_equal(a, b.astype(a.dtype))


# --------------------------------------------------------------- the walk --

@pytest.mark.parametrize("n,m", [(64, 256), (256, 2048), (512, 4096)])
@pytest.mark.parametrize("stable", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_walk_matches_jax(n, m, stable, seed):
    tables = _tables(jgen.rmat_graph(n, m, seed=seed + 1))
    kw = dict(batch=64, stable=stable)
    _assert_walks_equal(_jwalk(tables, seed, **kw),
                        _twalk(tables, seed, **kw))


@pytest.mark.parametrize("positions", [[0], [5, 1, 63], list(range(0, 64, 3))])
def test_walk_position_subsets_match_jax_and_the_full_batch(positions):
    tables = _tables(jgen.rmat_graph(256, 2048, seed=4))
    kw = dict(batch=64, stable=True)
    pos = np.asarray(positions, np.int32)
    want = _jwalk(tables, 3, pos, **kw)
    got = _twalk(tables, 3, pos, **kw)
    _assert_walks_equal(want, got)
    full = _twalk(tables, 3, **kw)[0]
    assert np.array_equal(got[0], full[pos])


@pytest.mark.parametrize("stable", [False, True])
@pytest.mark.parametrize("max_steps", [1, 2, 5])
def test_walk_max_steps_matches_jax(stable, max_steps):
    tables = _tables(jgen.rmat_graph(256, 2048, seed=5))
    kw = dict(batch=32, stable=stable, max_steps=max_steps)
    _assert_walks_equal(_jwalk(tables, 1, **kw), _twalk(tables, 1, **kw))


# Vertex 0's segment is in_cum[0:2] = (.2, .4) with a total of .9: a draw
# in [.4, .9) sends the reference's search to the segment's end, where it
# compares in_cum[2] (vertex 1's first weight, .1) and steps past it, so
# the walk moves to in_src[2] = 3, which is not an in-neighbour of 0.
OVERRUN = (np.asarray([0, 2, 3, 4, 4, 4], np.int32),
           np.asarray([1, 2, 3, 4], np.int32),
           np.asarray([0.2, 0.4, 0.1, 0.5], np.float32),
           np.asarray([0.9, 0.1, 0.5, 0.0, 0.0], np.float32))


@pytest.mark.parametrize("stable", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_segment_overrun_matches_jax(stable, seed):
    kw = dict(batch=256, stable=stable)
    want = _jwalk(OVERRUN, seed, **kw)
    got = _twalk(OVERRUN, seed, **kw)
    _assert_walks_equal(want, got)
    visited, _, roots = got
    from_zero = visited[roots == 0]
    # rows rooted at 0 reach vertices that no edge leads from to 0
    assert from_zero.shape[0] > 0
    assert from_zero[:, 3:].any()


def test_walk_search_iterations_reach_the_fixed_point():
    """`search_iters` cuts the reference's 32 iterations to where the
    search stops moving: the same rows as all 32."""
    tables = [torch.from_numpy(np.array(t)) for t in OVERRUN]
    assert sampler.search_iters(tables[0]) < 32
    for seed in range(4):
        short = sampler._walk_loop(prng.PRNGKey(seed), *tables, batch=128)
        full = sampler._walk_loop(prng.PRNGKey(seed), *tables, batch=128,
                                  iters=32)
        assert all(torch.equal(a, b) for a, b in zip(short, full))


def test_walk_zero_indegree_roots_match_jax():
    # vertices 3 and 4 have no in-edge (total 0): their walks stop at once
    want = _jwalk(OVERRUN, 9, batch=64)
    got = _twalk(OVERRUN, 9, batch=64)
    _assert_walks_equal(want, got)
    stopped = np.isin(got[2], (3, 4))
    assert stopped.any() and (got[0][stopped].sum(axis=1) == 1).all()


@pytest.mark.parametrize("stable", [False, True])
def test_walk_on_an_edgeless_graph(stable):
    """No walk moves: each row holds its root alone.  The reference
    cannot run this case (its search indexes the empty edge array and
    JAX raises), so the roots are held to its ``_setup``'s."""
    n = 8
    edgeless = (np.zeros(n + 1, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32), np.zeros(n, np.float32))
    with pytest.raises(IndexError):
        _jwalk(edgeless, 2, batch=16, stable=stable)
    visited, counter, roots = _twalk(edgeless, 2, batch=16, stable=stable)
    _, jroots, _, _ = jsampler._setup(jax.random.PRNGKey(2), 16, n, None,
                                      None, stable)
    assert np.array_equal(roots, np.asarray(jroots))
    assert np.array_equal(visited, np.eye(n, dtype=np.uint8)[roots])
    assert np.array_equal(counter, np.bincount(roots, minlength=n))


@pytest.mark.parametrize("name", ["LT", "LT-stable", "LT/walk",
                                  "LT/walk+stable"])
def test_registered_lt_samplers_match_jax(name):
    jg = jgen.rmat_graph(256, 2048, seed=6)
    tg = generators.rmat_graph(256, 2048, seed=6)
    with warnings.catch_warnings():
        # legacy spellings warn once a process in both packages
        warnings.simplefilter("ignore", DeprecationWarning)
        jfac = jsampler.get_sampler(name)
        tfac = sampler.get_sampler(name)
    jcfg, tcfg = JConfig(batch=64), IMMConfig(batch=64)
    js, ts = jfac(jg, jcfg), tfac(tg, tcfg)
    key = jax.random.PRNGKey(11)
    _assert_walks_equal([np.asarray(x) for x in js(key)],
                        [x.numpy() for x in ts(prng.PRNGKey(11))])
    if "stable" in name:
        pos = np.asarray([2, 9, 40], np.int32)
        _assert_walks_equal(
            [np.asarray(x) for x in js(key, positions=jnp.asarray(pos))],
            [x.numpy() for x in ts(prng.PRNGKey(11), positions=pos)])


def test_positional_walk_draws_through_uniform():
    """The positional walk's coins are ``kops.uniform`` (the
    ``uniform_draw`` kernel on the card): one dispatch a step."""
    from repro_torch import obs

    g = generators.rmat_graph(128, 1024, seed=2)
    obs.reset()
    obs.enable()
    sampler.get_sampler("LT/walk")(g, IMMConfig(batch=32))(prng.PRNGKey(0))
    snap = obs.snapshot()["counters"]
    obs.reset()
    draws = sum(v for k, v in snap.items()
                if "uniform_draw" in k and "kernels.dispatch" in k)
    assert draws == snap["sampler.steps"] > 0


# ------------------------------------------------------------------- imm --

@pytest.mark.parametrize("n,m,k,store", [(256, 2048, 5, "bitmap"),
                                         (512, 4096, 8, "bitmap"),
                                         (512, 4096, 8, "packed")])
def test_imm_under_lt_matches_jax(n, m, k, store):
    jg = jgen.rmat_graph(n, m, seed=3)
    tg = generators.rmat_graph(n, m, seed=3)
    kw = dict(k=k, model="LT", max_theta=2048, batch=128, seed=1,
              store=store)
    want = jimm(jg, JConfig(**kw))
    got = imm(tg, IMMConfig(**kw), device="cpu")
    assert list(np.asarray(want.seeds)) == list(got.seeds)
    assert got.influence == want.influence
    assert got.covered_frac == want.covered_frac
    assert (got.theta, got.rounds) == (want.theta, want.rounds)
    assert np.array_equal(np.asarray(want.counter), got.counter)


def test_im_run_takes_lt_and_walk():
    from repro_torch.launch import im_run

    out = im_run.run("com-Amazon", scale=0.002, k=5, max_theta=512,
                     model="LT", backend="walk", device="cpu",
                     log=lambda s: None)
    assert out["sampler"] == "LT/walk" and len(out["seeds"]) == 5


# -------------------------------------------------------------- builders --

@pytest.mark.parametrize("n,m,seed", [(100, 400, 0), (512, 3000, 5)])
def test_erdos_graph_matches_jax(n, m, seed):
    _same_graph(jgen.erdos_graph(n, m, seed=seed),
                generators.erdos_graph(n, m, seed=seed))
    _same_graph(jgen.erdos_graph(n, m, seed=seed, weighted_ic="wc"),
                generators.erdos_graph(n, m, seed=seed, weighted_ic="wc"))


@pytest.mark.parametrize("n,p", [(2, 0.5), (33, 0.25), (200, 1.0)])
def test_star_graph_matches_jax(n, p):
    _same_graph(jgen.star_graph(n, p=p, seed=3),
                generators.star_graph(n, p=p, seed=3))


@pytest.mark.parametrize("seed", [0, 4])
def test_build_graph_weighted_cascade_matches_jax(seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, 300, 2000), rng.integers(0, 300, 2000)
    _same_graph(jcsr.build_graph(src, dst, 300, seed=seed, weighted_ic="wc"),
                csr.build_graph(src, dst, 300, seed=seed, weighted_ic="wc"))


def test_build_graph_explicit_lt_weights_match_jax():
    g = jgen.rmat_graph(256, 2048, seed=8)
    src, dst, prob, w = jcsr.edge_arrays(g)
    # one rebuild may move in_lt_total by an ulp; the second is stable
    for _ in range(2):
        jg = jcsr.build_graph(src, dst, g.n, ic_prob=prob, lt_weight=w)
        tg = csr.build_graph(src, dst, g.n, ic_prob=prob, lt_weight=w)
        _same_graph(jg, tg)
        src, dst, prob, w = csr.edge_arrays(tg)
    rng = np.random.default_rng(2)
    w2 = rng.uniform(0, 0.1, src.shape[0])
    _same_graph(jcsr.build_graph(src, dst, g.n, lt_weight=w2, seed=3),
                csr.build_graph(src, dst, g.n, lt_weight=w2, seed=3))
