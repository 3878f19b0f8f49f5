"""The port's sampler axes against the JAX package's on the CPU: the
stable coins and the WC/GT marginals bitwise, every sparse cell (IC, WC,
GT, positional and +stable, with positions) bitwise, pow2 edge padding
invisible, and the registry: names, matrix, legacy aliases, stable
spellings, family checks, positions, resample, custom coin models and
the axes that still raise with their ROADMAP item."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import sampler as jsampler  # noqa: E402
from repro.core.engine import IMMConfig as JConfig  # noqa: E402
from repro.core.engine import InfluenceEngine as JEngine  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.graphs.csr import edge_arrays as jedge_arrays  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import sampler as smp  # noqa: E402
from repro_torch.core import ties  # noqa: E402
from repro_torch.core.engine import IMMConfig, InfluenceEngine  # noqa: E402
from repro_torch.graphs import csr, generators  # noqa: E402

BUILTIN = ("IC", "WC", "GT", "LT")
COIN_CELLS = [(m, s) for m in ("IC", "WC", "GT") for s in (False, True)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _graphs(n=96, m=768, seed=2):
    return jgen.rmat_graph(n, m, seed=seed), generators.rmat_graph(
        n, m, seed=seed)


# ---------------------------------------------------------- coins, tables ----

@pytest.mark.parametrize("n", [7, 300, 334_863])
def test_stable_coins_match_jax(n):
    """``_u01(_mix32(_mix32(id ^ k0) ^ pos*GOLD ^ k1))`` over vertex ids
    and over edge identities ``src * n + dst``, which wrap in uint32 at
    com-Amazon's n."""
    rng = np.random.default_rng(n)
    sub = prng.split(prng.PRNGKey(n), 3)[2]
    pos = np.array([0, 1, 5, 63, 2**20 + 3], np.int64)
    src = rng.integers(0, n, 500)
    dst = rng.integers(0, n, 500)
    juid = (jnp.asarray(src, jnp.uint32) * jnp.uint32(n)
            + jnp.asarray(dst, jnp.uint32))
    uid = ((torch.from_numpy(src) * n + torch.from_numpy(dst))
           & prng.MASK32).to(torch.int32)
    for jids, ids in ((jnp.arange(min(n, 4096), dtype=jnp.uint32),
                       torch.arange(min(n, 4096), dtype=torch.int32)),
                      (juid, uid)):
        kd = jnp.asarray(sub, jnp.uint32)
        jbb = jnp.asarray(pos, jnp.uint32)[:, None] * jnp.uint32(smp._GOLD)
        want = jsampler._u01(jsampler._mix32(
            jsampler._mix32(jids[None, :] ^ kd[0]) ^ jbb ^ kd[1]))
        bb = ((torch.from_numpy(pos) * smp._GOLD)
              & prng.MASK32).to(torch.int32)[:, None]
        got = smp._stable_uniform(sub, ids, bb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wc_gt_marginals_and_edge_arrays_match_jax():
    jg, g = _graphs(256, 2048, 5)
    for a, b in zip(csr.edge_arrays(g), jedge_arrays(jg)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    for name in ("IC", "WC", "GT"):
        got = smp._edge_probs(smp.get_model(name), g)
        want = jsampler.get_model(name).edge_probs(jg)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(csr.dense_ic_matrix(g),
                                  np.asarray(jsampler.dense_ic_matrix(jg)))


# ----------------------------------------------------------- sparse cells ----

@pytest.mark.parametrize("model,stable", COIN_CELLS)
def test_sparse_cells_match_jax_bitwise(model, stable):
    jg, g = _graphs(256, 2048, 3)
    name = smp.composed_name(model, "sparse", stable)
    key = prng.split(prng.PRNGKey(4), 2)[0]
    jfn = jsampler.bind_sampler(jsampler.get_sampler(name), jg,
                                JConfig(batch=64))
    fn = smp.get_sampler(name)(g, IMMConfig(batch=64))
    calls = [({}, {})]
    if stable:
        pos = [9, 0, 63, 9, 31]
        calls.append(({"positions": jnp.asarray(pos, jnp.int32)},
                      {"positions": np.asarray(pos)}))
    for jkw, kw in calls:
        want = jfn(jnp.asarray(key), **jkw)
        got = fn(key, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_stable_sparse_pads_edges_to_pow2_and_stays_bitwise():
    _, g = _graphs()                          # m = 768 -> pads to 1024
    fn = smp.make_sampler("IC", "sparse", stable=True)(g, IMMConfig(batch=32))
    key = prng.PRNGKey(9)
    v0, c0, r0 = smp._sparse_loop(key, g.edge_src.long(), g.edge_dst.long(),
                                  g.in_prob, n_nodes=g.n, batch=32,
                                  stable=True)
    for a, b in zip(fn(key), (v0, c0, r0)):
        assert torch.equal(a, b)
    src, _, prob = smp._pad_edges_pow2(g.edge_src, g.edge_dst, g.in_prob)
    assert src.shape[0] == 1024 and float(prob[g.m:].abs().sum()) == 0.0


@pytest.mark.parametrize("model", ["WC", "GT"])
def test_wc_gt_sparse_engine_matches_jax(model):
    jg, g = _graphs(192, 1536, 4)
    kw = dict(k=4, model=model, backend="sparse", batch=128,
              max_theta=512, seed=3)
    want = JEngine(jg, JConfig(**kw)).run()
    eng = InfluenceEngine(g, IMMConfig(**kw), device="cpu")
    got = eng.run()
    np.testing.assert_array_equal(got.seeds, want.seeds)
    assert (got.theta, got.covered_frac) == (want.theta, want.covered_frac)
    np.testing.assert_array_equal(got.counter, np.asarray(want.counter))


# --------------------------------------------------------------- registry ----

def _builtin(names):
    return sorted(x for x in names if x.split("/")[0].split("-")[0]
                  in BUILTIN)


def test_registry_names_and_matrix_match_jax():
    assert _builtin(smp.registered_samplers()) == _builtin(
        jsampler.registered_samplers())
    assert [c for c in smp.sampler_matrix() if c[0] in BUILTIN] == [
        c for c in jsampler.sampler_matrix() if c[0] in BUILTIN]
    assert smp.registered_backends() == ["dense", "pallas", "sparse", "walk"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for name in ("IC-dense", "IC-sparse-stable", "LT"):
            f = smp.get_sampler(name)
            assert f is smp.get_sampler(jsampler._LEGACY_ALIASES[name])


def test_legacy_names_warn_once_each():
    smp._LEGACY_WARNED.discard("IC-dense")
    with pytest.warns(DeprecationWarning, match="make_sampler"):
        smp.get_sampler("IC-dense")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        smp.get_sampler("IC-dense")
        smp.get_sampler("IC/dense")
        smp.get_sampler("WC/pallas+stable")


def test_stable_variant_spellings():
    for name in ("IC/dense", "LT/walk+stable", "IC-sparse", "LT-stable",
                 "my-custom-sampler"):
        assert smp.stable_variant(name) == jsampler.stable_variant(name)


def test_family_mismatch_fails_fast():
    with pytest.raises(ValueError, match="family"):
        smp.make_sampler("LT", "dense")
    with pytest.raises(ValueError, match="family"):
        smp.make_sampler("IC", "walk")
    with pytest.raises(ValueError, match="family"):
        smp.default_sampler_name(_graphs()[1],
                                 IMMConfig(model="IC", backend="walk"))
    with pytest.raises(ValueError, match="unknown diffusion model"):
        smp.make_sampler("SIR")
    with pytest.raises(ValueError, match="unknown traversal backend"):
        smp.make_sampler("IC", "fpga")


@pytest.mark.parametrize("backend", ["dense", "pallas", "sparse"])
def test_positional_cells_reject_positions(backend):
    fn = smp.make_sampler("IC", backend)(_graphs()[1], IMMConfig(batch=16))
    with pytest.raises(TypeError):
        fn(prng.PRNGKey(0), positions=np.array([0, 1]))


@pytest.mark.parametrize("model,backend", [(m, b) for m in ("IC", "WC", "GT")
                                           for b in ("dense", "pallas",
                                                     "sparse")])
def test_stable_cells_regenerate_row_subsets_exactly(model, backend):
    g = _graphs()[1]
    fn = smp.get_sampler(smp.composed_name(model, backend, True))(
        g, IMMConfig(batch=32))
    key = prng.PRNGKey(5)
    full, _, roots = fn(key)
    pos = np.array([3, 17, 4, 31])
    sub, cnt, sub_roots = fn(key, positions=pos)
    assert torch.equal(sub, full[torch.from_numpy(pos)])
    assert torch.equal(sub_roots, roots[torch.from_numpy(pos)])
    assert torch.equal(cnt, sub.sum(0, dtype=torch.int32))


@pytest.mark.parametrize("sampler", ["IC/dense+stable", "GT/pallas+stable",
                                     "WC/sparse+stable"])
def test_engine_resample_regenerates_recorded_rows(sampler):
    g = _graphs()[1]
    eng = InfluenceEngine(g, IMMConfig(batch=32, sampler=sampler),
                          device="cpu")
    assert eng.supports_row_resample
    key = prng.split(eng.key)[1]              # the first batch's key
    eng.extend(32)
    rows = eng.store.R[:32]
    full, counter = eng.resample(key)
    assert torch.equal(full, rows) and torch.equal(counter,
                                                   eng.store.counter)
    pos = [31, 0, 7]
    part, _ = eng.resample(key, positions=pos)
    assert torch.equal(part, rows[pos])
    positional = InfluenceEngine(g, IMMConfig(batch=32), device="cpu")
    assert not positional.supports_row_resample


def test_custom_coin_model_runs_every_backend():
    flat = smp.CoinModel("flat-0.05-port", lambda g: torch.full(
        (g.m,), 0.05))
    g = generators.rmat_graph(128, 1024, seed=3)
    cfg = IMMConfig(batch=64)
    key = prng.PRNGKey(2)
    out = {}
    for backend in ("dense", "sparse", "pallas"):
        v, c, _ = smp.make_sampler(flat, backend)(g, cfg)(key)
        assert torch.equal(c, v.sum(0, dtype=torch.int32))
        out[backend] = v.numpy()
    logq = smp.logq_from_probs(g, torch.full((g.m,), 0.05))
    _, _, roots = smp._dense_loop(key, logq, batch=64)
    report = ties.classify_runs(
        lambda t: smp._dense_loop(key, logq, batch=64, max_steps=t)[0]
        .numpy(),
        lambda t: smp._dense_loop(key, logq, batch=64, max_steps=t,
                                  kernel=True)[0].numpy(),
        lambda t: smp.dense_coins(key, t, batch=64, n_nodes=g.n).numpy(),
        logq.numpy(), roots.numpy(), max_steps=g.n)
    assert report["faults"] == []
    assert report["rows"] == int((out["dense"] != out["pallas"])
                                 .any(1).sum())


def test_post_import_model_resolves_through_config_path():
    smp.register_model(smp.CoinModel("flat-post-port", lambda g: torch.full(
        (g.m,), 0.1)))
    g = _graphs()[1]
    eng = InfluenceEngine(g, IMMConfig(model="flat-post-port", k=2,
                                       batch=32, max_theta=64), device="cpu")
    assert eng.sampler_name == "flat-post-port/dense"
    eng.extend(64)
    assert len(eng.select(2).seeds) == 2
    assert smp.stable_variant("flat-post-port/sparse") == \
        "flat-post-port/sparse+stable"
    with pytest.raises(ValueError, match="family"):
        smp.get_sampler("flat-post-port/walk")


def test_register_model_shadowing_reaches_composed_samplers():
    smp.register_model(smp.CoinModel("shadow-port", lambda g: torch.zeros(
        g.m)))
    g = _graphs()[1]
    fn = smp.get_sampler("shadow-port/dense")
    v, _, _ = fn(g, IMMConfig(batch=32))(prng.PRNGKey(0))
    assert int(v.sum(1).max()) == 1
    smp.register_model(smp.CoinModel("shadow-port", lambda g: torch.ones(
        g.m)))
    v2, _, _ = fn(g, IMMConfig(batch=32))(prng.PRNGKey(0))
    assert int(v2.sum(1).max()) > 1


def test_unported_axes_raise_with_their_roadmap_item():
    g = _graphs()[1]
    cfg = IMMConfig(batch=8)
    # the walk is ported (A4) and so is a mesh placement of it (A8):
    # each shard's block is its rows of the unplaced batch; a row subset
    # of a placed batch (the meshed streaming path, A8b) runs unplaced
    from repro_torch.core.store import BatchPlacement
    placement = BatchPlacement((torch.device("cpu"),) * 3)
    for name in ("LT/walk", "LT/walk+stable", "LT"):
        factory = smp.get_sampler(name)
        v, _, _ = factory(g, cfg)(prng.PRNGKey(0))
        assert v.shape == (8, g.n)
        blocks, _, _ = factory(g, cfg, placement=placement)(prng.PRNGKey(0))
        assert torch.equal(torch.cat(blocks), v)
    sub = smp.sample_lt_stable(prng.PRNGKey(0), g.dst_offsets, g.in_src,
                               g.in_lt_cum, g.in_lt_total, np.arange(2),
                               batch=8, placement=placement)[0]
    whole = smp.get_sampler("LT/walk+stable")(g, cfg)(prng.PRNGKey(0))[0]
    assert torch.equal(sub, whole[:2])
    rows, _, _ = smp.get_sampler("IC/sparse")(g, cfg)(prng.PRNGKey(0),
                                                      emit_l=8)
    assert rows.shape == (8, 8) and rows.dtype == torch.int32
    with pytest.raises(TypeError, match="positions"):
        smp.bind_sampler(smp.get_sampler("IC/dense"), g, cfg,
                         placement=placement)(prng.PRNGKey(0),
                                              positions=np.arange(2))
