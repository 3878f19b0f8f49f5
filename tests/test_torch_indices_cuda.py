"""The C4 index-list path on the card against the same cells on the CPU,
bitwise (integer work throughout: there is no tolerance): bitmap ->
index-list conversion, index-list selection with ties, the IndexStore's
hits, the engine with native index emission (each batch's coins through
the ``ic_sparse_hits`` kernel), the C4 chooser over the bitmap, packed
and compressed stores, and a snapshot written on the card and restored
on the host.

Every test here needs a CUDA device and skips without one; the file
imports neither JAX nor the JAX package (from the repo root, with
``PYTHONPATH=src``: ``python -m pytest -q -m cuda
tests/test_torch_indices_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import adaptive, selection  # noqa: E402
from repro_torch.core.engine import IMMConfig, InfluenceEngine  # noqa: E402
from repro_torch.core.store import make_store  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda

SEED_SETS = [[1, 2, 3], [5], [0, 7, 9, 11, 13], list(range(0, 90, 9))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rows(seed, theta, n, density):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((theta, n)) < density).astype(
        np.uint8))


@pytest.mark.parametrize("theta,n,density,l_max", [
    (300, 4099, 0.002, 16), (300, 4099, 0.05, 64), (17, 33, 1.0, 8),
    (17, 33, 0.0, 4), (2000, 70_001, 0.0005, 128)])
def test_bitmap_to_indices_on_the_card(cuda, theta, n, density, l_max):
    R = _rows(theta, theta, n, density)
    want = adaptive.bitmap_to_indices(R, l_max)
    got = adaptive.bitmap_to_indices(R.to(cuda), l_max)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(adaptive.indices_to_bitmap(got, n).cpu(),
                       adaptive.indices_to_bitmap(want, n))


@pytest.mark.parametrize("method", ["rebuild", "decrement"])
def test_select_sparse_on_the_card(cuda, method):
    R = _rows(3, 4096, 512, 0.01)
    R[:, 40] = R[:, 7] = (torch.rand(4096, generator=torch.Generator()
                                     .manual_seed(0)) < 0.3).to(torch.uint8)
    R_idx = adaptive.bitmap_to_indices(R, 64)
    valid = torch.rand(4096, generator=torch.Generator().manual_seed(1)) \
        < 0.9
    want = selection.select_sparse(R_idx, valid, 512, 20, method)
    got = selection.select_sparse(R_idx.to(cuda), valid.to(cuda), 512, 20,
                                  method)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert int(got[0][0]) == 7


def test_index_store_hits_on_the_card(cuda):
    n = 1000
    stores = {d: make_store("indices", n, device=d) for d in ("cpu", cuda)}
    for i, dens in enumerate((0.002, 0.01, 0.03)):
        b = _rows(i, 100, n, dens)
        for st in stores.values():
            st.add_batch(b)
    S = np.array([[1, 2, 3, 3], [7, 7, 7, 7], [0, 500, 999, 10],
                  [n, n, n, n]], np.int32)
    h, d = stores["cpu"], stores[cuda]
    assert torch.equal(d.R.cpu(), h.R) and d.l_pad == h.l_pad
    assert torch.equal(d.hits(S).cpu(), h.hits(S))
    assert torch.equal(d.counter.cpu(), h.counter)


def _run(graph, store, device, **kw):
    cfg = IMMConfig(k=4, seed=1, backend="sparse", store=store, **kw)
    eng = InfluenceEngine(graph, cfg, device=device)
    ops.reset_launches()
    res = eng.run()
    return eng, res, ops.launch_counts()


@pytest.mark.parametrize("graph,kw", [
    ("path", dict(batch=64, max_theta=256)),
    ("rmat", dict(batch=16, max_theta=128)),
    ("rmat_wide", dict(batch=256, max_theta=2048))])
def test_native_emission_on_the_card(cuda, graph, kw):
    g = {"path": lambda: generators.path_graph(512, p=0.5),
         "rmat": lambda: generators.rmat_graph(100, 3000, seed=0),
         "rmat_wide": lambda: generators.rmat_graph(4099, 16384, seed=2)
         }[graph]()
    eng, res, launches = _run(g, "indices", cuda, **kw)
    assert launches.get("ic_sparse_hits", 0) > 0
    assert launches.get("arena_commit", 0) == 0
    heng, hres, _ = _run(g, "indices", "cpu", **kw)
    _, bres, _ = _run(g, "bitmap", cuda, **kw)
    assert eng._emit_l == heng._emit_l and eng._emit_l <= g.n
    for r in (hres, bres):
        np.testing.assert_array_equal(res.seeds, r.seeds)
        np.testing.assert_array_equal(res.counter, r.counter)
        assert (res.theta, res.covered_frac) == (r.theta, r.covered_frac)
    assert torch.equal(eng.store.R.cpu(), heng.store.R)
    np.testing.assert_array_equal(eng.influences(SEED_SETS),
                                  heng.influences(SEED_SETS))
    for method in ("decrement", "fused-rebuild"):
        np.testing.assert_array_equal(eng.select(4, method=method).seeds,
                                      res.seeds)


@pytest.mark.parametrize("store", ["bitmap", "packed", "compressed"])
def test_forced_c4_on_the_card(cuda, store):
    g = generators.rmat_graph(128, 256, seed=1)
    kw = dict(batch=64, max_theta=256, adaptive_representation=True,
              sparse_rep_min_n=1, switch_ratio=1)
    eng, res, _ = _run(g, store, cuda, **kw)
    _, hres, _ = _run(g, store, "cpu", **kw)
    assert res.representation == hres.representation == "indices"
    np.testing.assert_array_equal(res.seeds, hres.seeds)
    assert res.covered_frac == hres.covered_frac
    view = eng.store.index_view(adaptive.l_pad_for(
        eng.store.coverage_stats()[1]))
    assert view.R.device.type == "cuda"


def test_snapshot_from_the_card_restores_on_the_host(cuda, tmp_path):
    g = generators.rmat_graph(100, 3000, seed=0)
    cfg = IMMConfig(k=4, seed=1, backend="sparse", store="indices",
                    batch=16, max_theta=128)
    eng = InfluenceEngine(g, cfg, device=cuda)
    eng.extend(64)
    eng.snapshot(str(tmp_path))
    host = InfluenceEngine(g, cfg, device="cpu")
    assert host.restore(str(tmp_path))
    rep = eng.replicate()
    assert rep.store.R.device.type == "cuda"
    for e in (eng, host, rep):
        e.extend(128)
    assert torch.equal(eng.store.counter.cpu(), host.store.counter)
    assert torch.equal(rep.store.counter, eng.store.counter)
    np.testing.assert_array_equal(host.select(4).seeds, eng.select(4).seeds)
