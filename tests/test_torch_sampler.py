"""repro_torch's sparse IC sampler and graphs, bitwise against the JAX
package's on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import sampler as jsampler  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core import sampler  # noqa: E402
from repro_torch.core.engine import IMMConfig  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("n,m,directed", [(128, 512, True),
                                          (512, 1500, False)])
def test_graph_arrays_match_jax(n, m, directed):
    jg = jgen.rmat_graph(n, m, seed=3, directed=directed)
    g = generators.rmat_graph(n, m, seed=3, directed=directed)
    assert (g.n, g.m) == (jg.n, jg.m)
    for f in dataclasses.fields(g):
        v = getattr(g, f.name)
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(getattr(jg, f.name)),
                                          err_msg=f.name)
    arrays = {f.name: np.asarray(getattr(jg, f.name))
              for f in dataclasses.fields(jg)}
    g2 = convert.graph_from_arrays(arrays)
    for f in dataclasses.fields(g2):
        v = getattr(g2, f.name)
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, getattr(g, f.name)), f.name


@pytest.mark.parametrize("n,m", [(64, 256), (256, 1024), (512, 2048)])
@pytest.mark.parametrize("seed", [0, 11])
def test_sparse_loop_matches_jax(n, m, seed):
    jg = jgen.rmat_graph(n, m, seed=seed)
    g = generators.rmat_graph(n, m, seed=seed)
    key = prng.split(prng.PRNGKey(seed), 3)[2]
    jv, jc, jr = jsampler._sparse_loop(
        jax.numpy.asarray(key), jg.edge_src, jg.edge_dst, jg.in_prob,
        n_nodes=n, batch=64)
    v, c, r = sampler._sparse_loop(key, g.edge_src.long(), g.edge_dst.long(),
                                   g.in_prob, n_nodes=n, batch=64)
    assert v.dtype == torch.uint8 and tuple(v.shape) == (64, n)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


def test_sparse_loop_max_steps_matches_jax():
    jg = jgen.rmat_graph(256, 1024, seed=2)
    g = generators.rmat_graph(256, 1024, seed=2)
    key = prng.PRNGKey(5)
    jv, _, _ = jsampler._sparse_loop(
        jax.numpy.asarray(key), jg.edge_src, jg.edge_dst, jg.in_prob,
        n_nodes=256, batch=32, max_steps=2)
    v, _, _ = sampler._sparse_loop(key, g.edge_src.long(), g.edge_dst.long(),
                                   g.in_prob, n_nodes=256, batch=32,
                                   max_steps=2)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_visited_rows_are_row_padded():
    g = generators.rmat_graph(100, 400, seed=0)
    v, _, _ = sampler._sparse_loop(prng.PRNGKey(0), g.edge_src.long(),
                                   g.edge_dst.long(), g.in_prob,
                                   n_nodes=100, batch=8)
    assert v.stride() == (112, 1)


@pytest.mark.parametrize("n,backend,model,stable", [
    (100, None, "IC", False), (5000, None, "IC", False),
    (100, "sparse", "IC", False), (5000, None, "LT", False),
    (5000, "pallas", "WC", True)])
def test_default_sampler_name_matches_jax(n, backend, model, stable):
    from repro.core.engine import IMMConfig as JCfg

    class G:
        pass
    g = G()
    g.n = n
    kw = dict(backend=backend, model=model, stable=stable)
    assert (sampler.default_sampler_name(g, IMMConfig(**kw))
            == jsampler.default_sampler_name(g, JCfg(**kw)))


_PLACED = {"placement": "two cpu shards"}


@pytest.mark.parametrize("name,kw,item", [
    ("LT/walk", _PLACED, "A8b"),
    ("LT/walk+stable", _PLACED, "A8b"),
    ("LT-stable", _PLACED, "A8b"),
    ("IC/dense", _PLACED, "A8b"),
    ("WC/sparse+stable", _PLACED, "A8b")])
def test_unported_samplers_name_their_roadmap_item(name, kw, item):
    """A mesh placement binds (A8), the walk's too (A4), and since
    ``item`` (A8b) a stable sampler re-samples a row subset of a placed
    batch: unplaced, bitwise those rows of the batch; a positional
    sampler takes no ``positions``, placed or not."""
    from repro_torch.core.store import BatchPlacement
    g = generators.rmat_graph(64, 256, seed=0)
    factory = sampler.get_sampler(name)
    placement = BatchPlacement((torch.device("cpu"),) * 2)
    cfg = IMMConfig(batch=8)
    bound = sampler.bind_sampler(factory, g, cfg, placement=placement)
    visited, _, _ = bound(prng.PRNGKey(0))
    assert [tuple(v.shape) for v in visited] == [(4, 64)] * 2, kw
    whole = factory(g, cfg)(prng.PRNGKey(0))[0]
    assert torch.equal(torch.cat(visited), whole)
    if "stable" not in name:
        with pytest.raises(TypeError, match="positions"):
            bound(prng.PRNGKey(0), positions=np.arange(2))
        return
    sub = bound(prng.PRNGKey(0), positions=np.array([6, 1]))[0]
    assert torch.equal(sub, whole[[6, 1]]), item
