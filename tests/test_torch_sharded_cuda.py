"""The meshed IM solve on the card against the same cells on the CPU,
bitwise (integer work throughout): ShardedStore tiles written and
counted by the kernels at tile widths that are not multiples of 16, the
coin kernels at a row offset, a 2x2 mesh of one card against a 2x2 mesh
of the host and the single-device engine, and — with two cards — every
kernel on ``cuda:1`` while ``cuda:0`` is current, and a 2x1 mesh across
both cards (the launch-device repair: a kernel launches on its
operands' card).

Every test here needs a CUDA device and skips without one (the
two-card cells without a second card); the file imports neither JAX
nor the JAX package (from the repo root, with ``PYTHONPATH=src``:
``python -m pytest -q -m cuda tests/test_torch_sharded_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.core.engine import IMMConfig, InfluenceEngine  # noqa: E402
from repro_torch.core.store import ShardedStore  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.graphs.partition import (  # noqa: E402
    balanced_vertex_partition,
)
from repro_torch.kernels import coins, ops  # noqa: E402
from repro_torch.kernels import coverage_matvec as cov  # noqa: E402
from repro_torch.kernels import packed_count as pc  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (a second card for the "
                    "launch-device cells)")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def grid(dev, shape):
    return Mesh([[dev] * shape[1] for _ in range(shape[0])],
                ("data", "vertex"))


def _rows(seed, B, n, density=0.2):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((B, n)) < density).astype(np.uint8))


@pytest.mark.parametrize("codec", ["bitmap", "packed", "compressed"])
@pytest.mark.parametrize("shape,n,balanced", [((2, 2), 83, False),
                                              ((1, 4), 1001, True),
                                              ((4, 1), 4099, False),
                                              ((2, 3), 250, True)])
def test_tiles_equal_the_host_tiles(cuda, shape, n, balanced, codec):
    """Tiles written by arena_commit (bitmap, packed) and counted by
    coverage_matvec, packed_count and token_count equal the host's tiles
    and the plain versions at odd tile widths."""
    part = None
    if balanced:
        dst = (n * np.random.default_rng(1).random(5 * n) ** 3).astype(int)
        part = balanced_vertex_partition(n, shape[1], dst=dst)
    stores = [ShardedStore(n, mesh=grid(d, shape), vertex_axis="vertex",
                           partition=part, codec=codec)
              for d in (cuda, "cpu")]
    ops.reset_launches()
    for i, B in enumerate((7, 256, 33)):
        rows = _rows(i, B, n)
        for s in stores:
            s.add_batch(rows.to(s.device))
    dev, host = stores
    launches = ops.launch_counts()
    if codec != "compressed":
        kernel = "arena_commit" if codec == "bitmap" else \
            "arena_commit_packed"
        assert launches.get(kernel, 0) == 3 * dev.D * dev.Dv
    assert torch.equal(dev.counter.cpu(), host.counter)
    assert torch.equal(dev.sizes.cpu(), host.sizes)
    rng = np.random.default_rng(9)
    for t in range(dev.D):
        alive = torch.from_numpy(rng.random(dev.cap_local) < 0.6)
        for v in range(dev.Dv):
            tile, htile = dev.tile(t, v), host.tile(t, v)
            assert torch.equal(tile.cpu(), htile)
            assert torch.equal(dev._counter[t][v].cpu(),
                               host._counter[t][v])
            if codec == "bitmap":
                got = ops.coverage_matvec(alive.to(cuda), tile)
                want = cov.coverage_matvec_plain(alive, htile)
            elif codec == "packed":
                got = ops.packed_count(tile, alive.to(cuda), n=dev.n_local)
                want = pc.packed_count_plain(htile, alive, dev.n_local)
            else:
                got = ops.token_count(tile, alive.to(cuda), n=dev.n_local)
                want = pc.token_count_plain(htile, alive, dev.n_local)
            assert torch.equal(got.cpu(), want)
    S = [[1, 2, 3], [n - 1] * 3, [0, n // 2, n // 3]]
    assert torch.equal(dev.hits(S).cpu(), host.hits(S))


@pytest.mark.parametrize("rows", [(0, 1), (3, 7), (128, 256), (255, 256)])
def test_coin_kernels_at_a_row_offset(cuda, rows):
    gen = torch.Generator().manual_seed(2)
    prob = torch.rand(4099, generator=gen)
    key = prng.split(prng.PRNGKey(5))[1]
    lo, hi = rows
    got = ops.ic_sparse_hits(key, prob.to(cuda), 256, rows=rows)
    assert torch.equal(got.cpu(), coins.ic_sparse_hits_plain(
        key, prob, 256, rows=rows))
    assert torch.equal(got, ops.ic_sparse_hits(key, prob.to(cuda),
                                               256)[lo:hi])
    n = 77
    u = ops.uniform(key, (256, n), device=cuda, start=lo * n,
                    count=(hi - lo) * n)
    assert torch.equal(u.cpu(), prng.uniform(key, (256, n), start=lo * n,
                                             count=(hi - lo) * n))
    with pytest.raises(ValueError, match="rows"):
        coins.ic_sparse_hits_cuda(key, prob.to(cuda), 256, rows=(7, 3))


@pytest.mark.parametrize("sampler", ["IC/sparse", "IC/pallas", "LT/walk",
                                     "WC/sparse+stable"])
def test_a_mesh_of_one_card_equals_the_host(cuda, sampler):
    g = generators.rmat_graph(700, 5600, seed=3)
    cfg = IMMConfig(k=6, sampler=sampler, max_theta=1024, seed=2,
                    partition="balanced")
    want = InfluenceEngine(g, cfg, device="cpu").run()
    for dev in (cuda, "cpu"):
        got = InfluenceEngine(g, cfg, mesh=grid(dev, (2, 2)),
                              vertex_axis="vertex").run()
        np.testing.assert_array_equal(got.seeds, want.seeds)
        assert (got.theta, got.rounds) == (want.theta, want.rounds)
        assert got.covered_frac == want.covered_frac
        np.testing.assert_array_equal(got.counter, want.counter)


def test_kernels_launch_on_their_operands_card(two_cards):
    """``cuda:0`` current, every operand on ``cuda:1``: each kernel runs
    there and equals its plain version; operands on two cards raise."""
    d0, d1 = two_cards
    gen = torch.Generator().manual_seed(4)
    R = (torch.rand((300, 1000), generator=gen) < 0.2).to(torch.uint8)
    alive = torch.rand(300, generator=gen) < 0.7
    with torch.cuda.device(d0):
        Rd = torch.zeros((300, 1008), dtype=torch.uint8, device=d1)[:, :1000]
        Rd.copy_(R)
        assert torch.equal(ops.coverage_matvec(alive.to(d1), Rd).cpu(),
                           cov.coverage_matvec_plain(alive, R))
        best, idx = ops.fused_select(alive.to(d1), Rd)
        assert int(idx) == int(torch.argmax(
            cov.coverage_matvec_plain(alive, R)))
        out = torch.zeros_like(Rd)
        cnt = torch.zeros(1000, dtype=torch.int32, device=d1)
        sizes = torch.zeros(300, dtype=torch.int32, device=d1)
        ops.arena_commit(Rd, out, cnt, sizes=sizes)
        assert torch.equal(out.cpu(), R) and torch.equal(
            cnt.cpu(), R.sum(0, dtype=torch.int32))
        key = prng.PRNGKey(1)
        prob = torch.rand(2001, generator=gen)
        assert torch.equal(ops.ic_sparse_hits(key, prob.to(d1), 9,
                                              rows=(4, 9)).cpu(),
                           coins.ic_sparse_hits_plain(key, prob, 9,
                                                      rows=(4, 9)))
        assert torch.equal(ops.uniform(key, (5, 33), device=d1).cpu(),
                           prng.uniform(key, (5, 33)))
        with pytest.raises(ValueError, match="one device"):
            ops.coverage_matvec(alive.to(d0), Rd)


def test_a_mesh_across_two_cards(two_cards):
    d0, d1 = two_cards
    g = generators.rmat_graph(700, 5600, seed=3)
    cfg = IMMConfig(k=6, sampler="IC/sparse", max_theta=1024, seed=2)
    want = InfluenceEngine(g, cfg, device="cpu").run()
    for devices in ([[d0], [d1]], [[d0, d1]]):
        eng = InfluenceEngine(g, cfg, mesh=Mesh(devices, ("data", "vertex")),
                              vertex_axis="vertex")
        got = eng.run()
        assert {str(x.device) for row in eng.store.view().R
                for x in row} == {str(d0), str(d1)}
        np.testing.assert_array_equal(got.seeds, want.seeds)
        np.testing.assert_array_equal(got.counter, want.counter)
