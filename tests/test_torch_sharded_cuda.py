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


# ------------------------------------------- the meshed lifecycle (A8b) ----

def _lifecycle(dev, codec, shape, part, n, policy=None, seed=5):
    """One scripted lifecycle on a mesh of ``dev``: batches, kills (a
    device mask), a padded repair, a compaction and more batches.
    Returns the store's host state, its counter, live bits and remaps."""
    from repro_torch.core.store import StorePressurePolicy
    st = ShardedStore(n, mesh=grid(dev, shape), vertex_axis="vertex",
                      partition=part, codec=codec,
                      policy=None if policy is None
                      else StorePressurePolicy(**policy))
    st.track_remaps = True
    rng = np.random.default_rng(seed)
    for B in (40, 33, 64):
        st.add_batch(_rows(int(rng.integers(1 << 30)), B, n, 0.05))
    dead = torch.from_numpy(rng.random(st.capacity) < 0.25).to(dev)
    st.kill_rows(dead)
    slots = np.flatnonzero(~st._live_host & st._filled_host())[:11]
    idx = np.concatenate([slots, np.full(16 - slots.size, -1)])
    st.replace_rows(idx, _rows(7, 16, n, 0.3).to(dev))
    st.compact()
    st.add_batch(_rows(8, 50, n, 0.02))
    return (st.state(), st.counter.cpu(), st._live_host.copy(),
            [r.tolist() for r in st.drain_remaps()], st)


@pytest.mark.parametrize("codec", ["bitmap", "packed", "compressed"])
@pytest.mark.parametrize("shape,n,balanced", [((2, 2), 83, False),
                                              ((1, 4), 1001, True),
                                              ((4, 1), 333, False)])
def test_tile_lifecycle_equals_the_host(cuda, codec, shape, n, balanced):
    """Kills, a padded repair and a compaction on tiles of the card, the
    counter partials through the kernels (coverage_matvec, packed_count,
    token_count; arena_commit for bitmap and packed repairs): state,
    counter, live bits and remaps equal the same script on the host, and
    the counter is the live rows' sum."""
    part = (balanced_vertex_partition(n, shape[1], dst=np.arange(n) ** 2 % n)
            if balanced else None)
    ops.reset_launches()
    got = _lifecycle(cuda, codec, shape, part, n)
    launches = ops.launch_counts()
    want = _lifecycle("cpu", codec, shape, part, n)
    for k in want[0]:
        assert np.array_equal(np.asarray(got[0][k]), np.asarray(want[0][k])), k
    assert torch.equal(got[1], want[1])
    assert np.array_equal(got[2], want[2]) and got[3] == want[3]
    assert torch.equal(got[1], torch.from_numpy(
        got[0]["R"].sum(0).astype(np.int32)))
    kill_kernel = {"bitmap": "coverage_matvec", "packed": "packed_count",
                   "compressed": "token_count"}[codec]
    assert launches.get(kill_kernel, 0) > 0
    if codec != "compressed":
        commit = "arena_commit" + ("_packed" if codec == "packed" else "")
        # every tile's writes: 3 batches, the repair, one more batch
        assert launches.get(commit, 0) >= shape[0] * shape[1]


def _pressure(dev, shape, n, max_bytes):
    """Packed tiles under a byte cap with the ladder: over the cap they
    morph to tokens, then evict per shard; a kill and a repair after.
    Returns the host state, counter and the store."""
    from repro_torch.core.store import StorePressurePolicy
    st = ShardedStore(n, mesh=grid(dev, shape), vertex_axis="vertex",
                      codec="packed", policy=StorePressurePolicy(
                          max_bytes=max_bytes, ladder=("compressed",)))
    for i in range(14):
        st.add_batch(_rows(100 + i, 16 * shape[0], n, 0.004))
        assert max(st.counts) <= st.row_cap // st.D
        assert st.capacity * st._row_bytes() <= max_bytes
    dead = np.zeros(st.capacity, bool)
    dead[[0, 3, st.cap_local + 1]] = True
    st.kill_rows(dead)
    st.replace_rows(np.flatnonzero(dead), _rows(9, 3, n, 0.004).to(dev))
    assert st.capacity * st._row_bytes() <= max_bytes
    return st.state(), st.counter.cpu(), st


@pytest.mark.parametrize("shape", [(2, 1), (4, 1)])
def test_tile_ladder_and_eviction_equal_the_host(cuda, shape):
    """A byte cap that sends packed tiles down the ladder to tokens and
    then evicts per shard: the same store on the card and the host."""
    n = 1024                        # 128 packed bytes a row, 32 as tokens
    max_bytes = shape[0] * 40 * 128
    got = _pressure(cuda, shape, n, max_bytes)
    want = _pressure("cpu", shape, n, max_bytes)
    assert got[2].representation == want[2].representation == "compressed"
    assert got[2].count == got[2].row_cap < 14 * 16 * shape[0]
    for k in want[0]:
        assert np.array_equal(np.asarray(got[0][k]), np.asarray(want[0][k])), k
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[1], torch.from_numpy(
        got[0]["R"].sum(0).astype(np.int32)))


@pytest.mark.parametrize("sampler", ["IC/pallas+stable", "LT/walk+stable",
                                     "IC/sparse+stable"])
def test_a_meshed_stream_on_the_card_equals_the_host(cuda, sampler):
    """A stream on a 2x2 mesh of the card under deltas, drained, equals
    the same stream on a 2x2 mesh of the host and the single-device
    stream on the host (the pallas BFS column-blocked on the tiles)."""
    from repro_torch import stream as tst
    g = generators.rmat_graph(600, 4800, seed=3, weighted_ic="wc")
    cfg = IMMConfig(k=6, sampler=sampler, batch=64, seed=2, store="packed",
                    partition="balanced")
    runs = []
    for kw in ({"mesh": grid(cuda, (2, 2)), "vertex_axis": "vertex"},
               {"mesh": grid("cpu", (2, 2)), "vertex_axis": "vertex"},
               {"device": "cpu"}):
        s = tst.StreamEngine(g, cfg, **kw)
        s.extend(512)
        rng = np.random.default_rng(4)
        stale = [s.apply_delta(tst.random_delta(s.graph, rng, inserts=8,
                                                deletes=8, reweights=8))
                 for _ in range(2)]
        s.refresh()
        runs.append((stale, s.store.counter.cpu(), s.select(6).seeds))
    for stale, counter, seeds in runs[1:]:
        assert stale == runs[0][0]
        assert torch.equal(counter, runs[0][1])
        np.testing.assert_array_equal(seeds, runs[0][2])


@pytest.mark.parametrize("w_lo,w_hi", [(0, 97), (500, 1003), (1000, 1003)])
def test_frontier_step_on_a_column_block(cuda, w_lo, w_hi):
    """ic_frontier_step on a column block of logq (n rows by w output
    columns, as a tile of a meshed BFS hands it) equals its plain version
    bitwise, and the whole table's step on those columns."""
    from repro_torch.kernels import ic_frontier as icf
    gen = torch.Generator().manual_seed(3)
    n, B = 1003, 70
    L = torch.where(torch.rand(n, n, generator=gen) < 0.01,
                    torch.log1p(-torch.rand(n, n, generator=gen)),
                    torch.zeros(()))
    F = torch.rand(B, n, generator=gen) < 0.3
    V = torch.rand(B, n, generator=gen) < 0.2
    R = torch.rand(B, n, generator=gen)
    blk = L[:, w_lo:w_hi].contiguous()
    cols = icf.column_form(blk.to(cuda))
    got = ops.ic_frontier_step(F.to(cuda), V[:, w_lo:w_hi].to(cuda), None,
                               R[:, w_lo:w_hi].to(cuda), cols=cols)
    plain = icf.ic_frontier_step_plain(F, V[:, w_lo:w_hi], blk,
                                       R[:, w_lo:w_hi])
    whole = icf.ic_frontier_step_plain(F, V, L, R)[:, w_lo:w_hi]
    assert torch.equal(got.cpu(), plain) and torch.equal(plain, whole)
    assert got.stride(0) % 16 == 0


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_dense_refuses_tf32_on_any_layout(cuda, shape):
    """The dense backend is specified in float32: with TF32 matmuls on it
    raises, unplaced and column-blocked over a 2D mesh's vertex tiles."""
    g = generators.rmat_graph(300, 2400, seed=3)
    cfg = IMMConfig(k=4, sampler="IC/dense", max_theta=256, seed=2,
                    partition="balanced")
    kw = (dict(device=cuda) if shape == (1, 1) else
          dict(mesh=grid(cuda, shape), vertex_axis="vertex"))
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        eng = InfluenceEngine(g, cfg, **kw)
        with pytest.raises(RuntimeError, match="allow_tf32"):
            eng.extend(256)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
