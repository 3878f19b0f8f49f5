"""The port's meshed IM solve (`repro_torch.mesh`, `ShardedStore`, the
sharded selections, the sampler's placement, the meshed engine) on the
CPU, against the JAX package's *single-device* results, which a mesh
must equal seed for seed.  Meshes here repeat the ``cpu`` device (the
port's counterpart of XLA's forced host device count): 1x1, 2x1, 1x2,
2x2 and 4x1, equal and balanced vertex blocks, bitmap, packed and token
tiles; one torch thread."""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import imm_snap as jsnap  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.core.engine import IMMConfig as JConfig  # noqa: E402
from repro.core.engine import InfluenceEngine as JEngine  # noqa: E402
from repro.core.store import ShardedStore as JShardedStore  # noqa: E402
from repro.core.store import store_from_state as jstore_from_state  # noqa
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.configs import imm_snap  # noqa: E402
from repro_torch.core import sampler as smp  # noqa: E402
from repro_torch.core import selection  # noqa: E402
from repro_torch.core.adaptive import bitmap_to_indices  # noqa: E402
from repro_torch.core.engine import IMMConfig, InfluenceEngine  # noqa: E402
from repro_torch.core.store import (  # noqa: E402
    BatchPlacement, BitmapStore, ShardedStore, make_store, store_from_state,
)
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.graphs.partition import (  # noqa: E402
    balanced_vertex_partition,
)
from repro_torch.mesh import Mesh  # noqa: E402

torch.set_num_threads(1)

LAYOUTS = ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1))
CODECS = ("bitmap", "packed", "compressed")
METHODS = ("rebuild", "decrement", "fused-rebuild", "fused-decrement")
N = 83                      # not a multiple of 16, nor of 8


def cpu_mesh(shape):
    return Mesh([["cpu"] * shape[1] for _ in range(shape[0])],
                ("data", "vertex"))


def _rows(rng, B, n=N, density=0.2):
    return torch.from_numpy((rng.random((B, n)) < density).astype(np.uint8))


def _partition(shape, balanced, rng, n=N):
    if not balanced:
        return None
    dst = (n * rng.random(6 * n) ** 3).astype(np.int64)
    return balanced_vertex_partition(n, shape[1], dst=dst)


def _store(shape, codec, part, n=N):
    return ShardedStore(n, mesh=cpu_mesh(shape), vertex_axis="vertex",
                        partition=part, codec=codec)


def _global_rows(ss):
    """``(capacity, n)`` uint8 of a sharded store in global slot order
    (decoded tile by tile)."""
    out = np.zeros((ss.capacity, ss.n), np.uint8)
    for t in range(ss.D):
        for v in range(ss.Dv):
            bits = ss.codec.decode_np(ss.tile(t, v).numpy())
            lo, w = ss.col_lo[v], ss.col_width[v]
            out[t * ss.cap_local:(t + 1) * ss.cap_local, lo:lo + w] = \
                bits[:, :w]
    return out


# ------------------------------------------------------------- (i) store ----

@pytest.mark.parametrize("balanced", [False, True])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("shape", LAYOUTS)
def test_store_matches_bitmap_store(shape, codec, balanced):
    rng = np.random.default_rng(
        zlib.crc32(repr((shape, codec, balanced)).encode()))
    ss = _store(shape, codec, _partition(shape, balanced, rng))
    bs = BitmapStore(N, device="cpu")
    batches = [_rows(rng, B) for B in (5, 16, 3, 33)]
    all_slots = []
    for rows in batches:
        counts, cap = ss.counts, None
        slots = ss.add_batch(rows)
        cap = ss.cap_local
        b = -(-rows.shape[0] // ss.D)
        want = [t * cap + counts[t] + i
                for t in range(ss.D)
                for i in range(min(max(rows.shape[0] - t * b, 0), b))]
        np.testing.assert_array_equal(slots, want)
        bs.add_batch(rows)
        all_slots.append(slots)
    assert ss.count == bs.count and ss.counts.sum() == bs.count
    # growth keeps every shard's rows in place: slot t * cap + i now
    R = _global_rows(ss)
    cap_then = [s // ss.cap_local for s in np.concatenate(all_slots)]
    assert max(cap_then) < ss.D
    valid = np.concatenate([m.numpy() for m in ss.valid_mask()])
    got = R[valid]
    want = bs.R[:bs.count].numpy()
    assert sorted(map(bytes, got)) == sorted(map(bytes, want))
    assert torch.equal(ss.counter, bs.counter)
    assert torch.equal(ss.sizes[torch.from_numpy(valid)],
                       torch.from_numpy(R[valid].sum(1).astype(np.int32)))
    S = [[1, 2, 3], [82, 82, 82], [0, 40, 41], [17, 5, 80]]
    assert torch.equal(ss.hits(S), bs.hits(S))
    verts = np.array([3, 40, 81, 0])
    mask = np.array([True, True, True, False])
    touch = ss.rows_touching_cols(verts, mask).numpy()
    np.testing.assert_array_equal(
        touch, (R[:, verts[mask]] > 0).any(axis=1))
    # every tile's pad columns and its rows past the count stay empty
    for t in range(ss.D):
        for v in range(ss.Dv):
            bits = ss.codec.decode_np(ss.tile(t, v).numpy())
            assert not bits[:, ss.col_width[v]:].any()
            assert not bits[ss.counts[t]:].any()
    st = ss.state()
    assert st["R"].shape == (bs.count, N)
    assert sorted(map(bytes, st["R"])) == sorted(map(bytes, want))


@pytest.mark.parametrize("codec", CODECS)
def test_1x1_state_equals_the_jax_sharded_store(codec):
    rng = np.random.default_rng(7)
    jmesh = jax.make_mesh((1, 1), ("data", "vertex"))
    js = JShardedStore(N, mesh=jmesh, vertex_axis="vertex", codec=codec)
    ts = _store((1, 1), codec, None)
    for B in (5, 16, 40):
        rows = _rows(rng, B)
        jslots = js.add_batch(jnp.asarray(rows.numpy()))
        np.testing.assert_array_equal(ts.add_batch(rows), jslots)
    want, got = js.state(), ts.state()
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    assert ts.capacity == js.capacity and ts.cap_local == js.cap_local
    assert ts.n_pad == js.n_pad and ts.n_local == js.n_local


# -------------------------------------------------------- (ii) selection ----

@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("shape", LAYOUTS)
def test_sharded_selections_equal_jax_single_device(shape, codec):
    rng = np.random.default_rng(11)
    part = _partition(shape, shape[1] > 1, rng)
    ss = _store(shape, codec, part)
    rows = []
    for B in (40, 33, 27):
        r = _rows(rng, B, density=0.08)
        r[:, 5] = 1 if B == 33 else r[:, 5]      # a hub, and ties below
        rows.append(r)
        ss.add_batch(r)
    R = np.concatenate([r.numpy() for r in rows])
    valid = np.ones(R.shape[0], bool)
    idx = np.asarray(bitmap_to_indices(torch.from_numpy(R), 32))
    k = 9
    mesh = ss.mesh
    view = ss.view()
    iview = ss.index_view(32)
    for method in METHODS:
        base = method.replace("fused-", "")
        want = jsel.select_dense(jnp.asarray(R), jnp.asarray(valid), k, base)
        want_sp = jsel.select_sparse(jnp.asarray(idx), jnp.asarray(valid),
                                     N, k, base)
        for w in (want, want_sp):
            np.testing.assert_array_equal(np.asarray(want[0]),
                                          np.asarray(w[0]))
        for layout, v in (("sharded", view), ("sharded-sparse", iview)):
            got = selection.get_selection(method, layout)(
                v, k, mesh=mesh, vertex_axis="vertex",
                partition=ss.partition, codec=ss.codec)
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(want[0]))
            np.testing.assert_array_equal(got[2].numpy(),
                                          np.asarray(want[2]))
            assert float(got[1]) == float(want[1])


def test_single_device_views_scatter_and_ripples_baseline():
    """A single-device store's arena selected on a mesh (the reference
    scatters it on entry) and the vertex-partitioned baseline both give
    the single-device seeds."""
    rng = np.random.default_rng(3)
    bs = BitmapStore(N, device="cpu")
    bs.add_batch(_rows(rng, 50, density=0.1))
    want = jsel.select_dense(jnp.asarray(bs.R.numpy()),
                             jnp.asarray(bs._valid().numpy()), 7)
    got = selection.get_selection("rebuild", "sharded")(
        bs.view(), 7, mesh=cpu_mesh((2, 2)), vertex_axis="vertex")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    idx = bitmap_to_indices(bs.R, 16)
    jwant = jsel.select_vertex_partitioned(
        jnp.asarray(idx.numpy()), jnp.asarray(bs._valid().numpy()), N, 7)
    got = selection.select_vertex_partitioned(idx, bs._valid(), N, 7)
    for a, b in zip(got, jwant):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ----------------------------------------------------------- (iii) engine ----

_JAX_RUNS = {}


def _graph_pair(n=300, m=2400, seed=0):
    return (jgen.rmat_graph(n, m, seed=seed),
            generators.rmat_graph(n, m, seed=seed))


def _jax_run(sampler):
    if sampler not in _JAX_RUNS:
        jg, _ = _graph_pair()
        eng = JEngine(jg, JConfig(k=5, max_theta=1024, sampler=sampler,
                                  seed=1))
        _JAX_RUNS[sampler] = (eng.run(), eng)
    return _JAX_RUNS[sampler]


ENGINE_CELLS = [
    ("IC/sparse", (2, 2), "equal", "auto"),
    ("IC/sparse", (1, 2), "balanced", "packed"),
    ("WC/sparse", (4, 1), "equal", "compressed"),
    ("GT/sparse", (2, 2), "balanced", "auto"),
    ("IC/dense", (2, 1), "equal", "auto"),
    ("IC/dense", (1, 2), "balanced", "compressed"),
    ("IC/pallas", (2, 2), "equal", "packed"),
]


@pytest.mark.parametrize("sampler,shape,part,store", ENGINE_CELLS)
def test_meshed_engine_equals_jax_single_device(sampler, shape, part, store):
    """Sparse samplers are exact against JAX; the dense and pallas ones
    are held to JAX up to near-ties (`repro_torch.core.ties`), and this
    graph's solve has none: the rows, hence seeds, theta, rounds and
    counter, are the reference's."""
    want, jeng = _jax_run(sampler)
    _, g = _graph_pair()
    cfg = IMMConfig(k=5, max_theta=1024, sampler=sampler, seed=1,
                    partition=part, store=store)
    eng = InfluenceEngine(g, cfg, mesh=cpu_mesh(shape),
                          vertex_axis="vertex")
    got = eng.run()
    assert isinstance(eng.store, ShardedStore)
    assert eng.store.representation == (
        "bitmap" if store == "auto" else store)
    np.testing.assert_array_equal(got.seeds, np.asarray(want.seeds))
    assert (got.theta, got.rounds) == (want.theta, want.rounds)
    assert got.covered_frac == want.covered_frac
    assert got.influence == want.influence
    np.testing.assert_array_equal(got.counter, np.asarray(want.counter))
    for method in ("decrement", "fused-rebuild"):
        np.testing.assert_array_equal(eng.select(5, method=method).seeds,
                                      np.asarray(want.seeds))
    np.testing.assert_array_equal(
        eng.influences([[1, 2], list(got.seeds)]),
        jeng.influences([[1, 2], list(np.asarray(want.seeds))]))


def test_meshed_engine_c4_takes_the_tile_index_view():
    """With C4 on and sparse sets, a meshed engine selects through the
    tiles' index view (``sharded-sparse``; the choice is made per vertex
    shard, on its n_local columns, as the reference's is) and picks the
    single-device reference's seeds."""
    jg, g = _graph_pair(400, 1200, 2)
    kw = dict(k=4, max_theta=512, sampler="WC/sparse", seed=3,
              sparse_rep_min_n=16, switch_ratio=4)
    want = JEngine(jg, JConfig(**kw)).run()
    eng = InfluenceEngine(g, IMMConfig(**kw), mesh=cpu_mesh((2, 2)),
                          vertex_axis="vertex")
    got = eng.run()
    assert got.representation == "indices"
    assert eng.store.max_local_size() * 4 < eng.store.n_local
    np.testing.assert_array_equal(got.seeds, np.asarray(want.seeds))
    assert got.covered_frac == want.covered_frac


# -------------------------------------------------------- (iv) snapshots ----

def test_snapshots_cross_packages_and_layouts():
    jg, g = _graph_pair()
    kw = dict(k=5, max_theta=1024, sampler="IC/sparse", seed=1)
    eng = InfluenceEngine(g, IMMConfig(**kw, partition="balanced"),
                          mesh=cpu_mesh((2, 2)), vertex_axis="vertex")
    res = eng.run()
    tree = eng.snapshot_tree()
    assert str(tree["store"]["kind"]) == "sharded"
    # the port's 2x2 snapshot in the JAX package, without a mesh
    jst = jstore_from_state({k: np.asarray(v)
                             for k, v in tree["store"].items()})
    jview = jst.view()
    want = jsel.select_dense(jview.R, jview.valid, 5)
    np.testing.assert_array_equal(res.seeds, np.asarray(want[0]))
    assert res.covered_frac == float(want[1])
    # ... and in the port: on a 1x1 mesh, and into a BitmapStore
    one = InfluenceEngine(g, IMMConfig(**kw), mesh=cpu_mesh((1, 1)),
                          vertex_axis="vertex")
    one.restore_tree(tree)
    flat = InfluenceEngine(g, IMMConfig(**kw, store="bitmap"), device="cpu")
    flat.restore_tree(tree)
    assert isinstance(flat.store, BitmapStore)
    for e in (one, flat, eng.replicate()):
        np.testing.assert_array_equal(e.select(5).seeds, res.seeds)
    # a JAX single-device snapshot restored on the port's 2x2 mesh
    jeng = JEngine(jg, JConfig(**kw))
    jres = jeng.run()
    jtree = jeng.snapshot_tree()
    mesh_eng = InfluenceEngine(g, IMMConfig(**kw), mesh=cpu_mesh((2, 2)),
                               vertex_axis="vertex")
    mesh_eng.restore_tree(convert.engine_state_from_tree(
        {"store": {k: np.asarray(v) for k, v in jtree["store"].items()},
         "key": np.asarray(jtree["key"]), "meta": jtree["meta"]}))
    assert isinstance(mesh_eng.store, ShardedStore)
    sel = mesh_eng.select(5)
    np.testing.assert_array_equal(sel.seeds, np.asarray(jres.seeds))
    assert sel.covered_frac == jres.covered_frac
    # the same file format both ways: the restored engine extends on
    assert mesh_eng.extend(jres.theta + 256) == jeng.extend(jres.theta + 256)
    np.testing.assert_array_equal(mesh_eng.store.counter.numpy(),
                                  np.asarray(jeng.store.counter))


def test_store_from_state_targets():
    rng = np.random.default_rng(5)
    bs = BitmapStore(N, device="cpu")
    bs.add_batch(_rows(rng, 30))
    for codec in CODECS:
        ss = store_from_state(bs.state(), mesh=cpu_mesh((2, 2)),
                              vertex_axis="vertex", kind=codec)
        assert ss.representation == codec
        assert torch.equal(ss.counter, bs.counter)
        back = store_from_state(ss.state(), device="cpu")
        assert back.representation == codec and torch.equal(
            back.counter, bs.counter)
    with pytest.raises(ValueError, match="needs a mesh"):
        store_from_state(bs.state(), kind="sharded")
    idx = make_store("indices", N, device="cpu")
    idx.add_batch(_rows(rng, 4))
    with pytest.raises(ValueError, match="on a mesh"):
        store_from_state(idx.state(), mesh=cpu_mesh((1, 1)))


# --------------------------------------------------------- (v) placement ----

PLACED = ("IC/sparse", "IC/sparse+stable", "WC/sparse", "GT/sparse+stable",
          "IC/dense", "IC/dense+stable", "IC/pallas", "WC/pallas+stable",
          "LT/walk", "LT/walk+stable")


@pytest.mark.parametrize("name", PLACED)
def test_placed_blocks_are_the_unplaced_rows(name):
    g = generators.rmat_graph(120, 700, seed=4)
    cfg = IMMConfig(batch=10)
    factory = smp.get_sampler(name)
    full, counter, roots = factory(g, cfg)(prng.PRNGKey(9))
    placement = BatchPlacement((torch.device("cpu"),) * 4)
    blocks, counters, broots = smp.bind_sampler(
        factory, g, cfg, placement=placement)(prng.PRNGKey(9))
    assert [b.shape[0] for b in blocks] == [3, 3, 3, 1]
    assert torch.equal(torch.cat(blocks), full)
    assert torch.equal(torch.cat(broots), roots)
    assert torch.equal(sum(counters), counter)


def test_placed_batches_land_on_the_shards():
    """A sharded store takes a placed batch (one block per theta shard)
    and a whole batch alike, and refuses blocks that do not split the
    batch as its placement does."""
    rng = np.random.default_rng(2)
    rows = _rows(rng, 10)
    a, b = _store((4, 1), "bitmap", None), _store((4, 1), "bitmap", None)
    blocks = [rows[lo:hi] for _, lo, hi in a.batch_placement.blocks(10)]
    np.testing.assert_array_equal(a.add_batch(blocks), b.add_batch(rows))
    assert np.array_equal(_global_rows(a), _global_rows(b))
    with pytest.raises(ValueError, match="splits as"):
        a.add_batch([rows[:4], rows[4:6], rows[6:8], rows[8:]])


# ---------------------------------------------------- (vi) mesh helpers ----

@pytest.mark.parametrize("spec", [None, 0, 1, 3, "auto", "2x2", "4x1",
                                  "1x4", (2, 3)])
def test_make_im_mesh_clips_as_the_reference(spec, monkeypatch):
    avail = jax.device_count()
    monkeypatch.setattr(imm_snap, "_available",
                        lambda device: [torch.device("cpu")] * avail)
    want = jsnap.make_im_mesh(spec)
    got = imm_snap.make_im_mesh(spec, device="cpu")
    if want is None:
        assert got is None
        return
    assert dict(got.shape) == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert (sorted(imm_snap.mesh_engine_kwargs(got))
            == sorted(jsnap.mesh_engine_kwargs(want)))
    kw = imm_snap.mesh_engine_kwargs(got)
    assert kw["theta_axes"] == jsnap.mesh_engine_kwargs(want)["theta_axes"]
    assert imm_snap.make_im_mesh(got) is got
    assert (imm_snap.THETA_AXIS, imm_snap.VERTEX_AXIS) == (
        jsnap.THETA_AXIS, jsnap.VERTEX_AXIS)
    for name in ("IMM_DRYRUN_CELLS", "SAMPLER_MATRIX_CELLS",
                 "SAMPLER_MATRIX_BACKENDS", "IM_SERVE_CELLS"):
        assert getattr(imm_snap, name) == getattr(jsnap, name)


def test_mesh_tiles_and_collectives():
    mesh = Mesh([["cpu", "cpu", "cpu"], ["cpu", "cpu", "cpu"]],
                ("data", "vertex"))
    assert mesh.shape == {"data": 2, "vertex": 3} and mesh.size == 6
    assert len(mesh.tile_devices(("data",), "vertex")[0]) == 3
    assert len(mesh.tile_devices(("data", "vertex"))) == 6
    assert len(mesh.tile_devices("data")) == 2
    with pytest.raises(ValueError, match="not in mesh axes"):
        mesh.tile_devices(("theta",))
    with pytest.raises(ValueError, match="2-d device grid"):
        Mesh(["cpu", "cpu"], ("data", "vertex"))
    from repro_torch import mesh as m
    parts = [torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])]
    assert torch.equal(m.psum(parts, "cpu"), torch.tensor([4.0, 6.0]))
    assert torch.equal(m.all_gather(parts, "cpu"), torch.stack(parts))
    assert torch.equal(m.psum_or([torch.tensor([True, False]),
                                  torch.tensor([False, False])], "cpu"),
                       torch.tensor([True, False]))
    assert torch.equal(parts[0], torch.tensor([1.0, 2.0]))   # not in place


# ----------------------------------------------------------- (vii) A8b ----

def test_the_row_lifecycle_waits_for_a8b():
    """Ported since (ROADMAP A8b): what raised here now runs.  The
    lifecycle calls keep the store's rows and counter in step, a policy
    is taken, and a meshed stable engine re-samples a row subset of a
    placed batch: bitwise those rows of the unplaced batch."""
    from repro_torch.core.store import StorePressurePolicy
    ss = _store((2, 2), "bitmap", None)
    rows = _rows(np.random.default_rng(0), 8)
    ss.add_batch(rows)
    dead = np.zeros(ss.capacity, bool)
    dead[[0, ss.cap_local]] = True
    assert ss.kill_rows(dead) == 2
    fresh = _rows(np.random.default_rng(1), 2)
    ss.replace_rows(np.flatnonzero(dead), fresh)
    assert ss.dead == 0 and ss.compact() is None and ss.drain_remaps() == []
    want = torch.cat([rows[1:4], rows[5:], fresh]).sum(0, dtype=torch.int32)
    assert torch.equal(ss.counter, want)
    assert not ss._compress_step()
    assert ShardedStore(N, mesh=cpu_mesh((1, 1)), policy=StorePressurePolicy(
        max_rows=64)).row_cap == 64
    g = generators.rmat_graph(64, 256, seed=0)
    cfg = IMMConfig(batch=8, sampler="IC/sparse+stable")
    eng = InfluenceEngine(g, cfg, mesh=cpu_mesh((2, 1)),
                          vertex_axis="vertex")
    assert eng.supports_row_resample
    sub = eng._sample(prng.PRNGKey(0), positions=np.arange(2))
    whole = smp.get_sampler(cfg.sampler)(g, cfg)(prng.PRNGKey(0))
    assert torch.equal(sub[0], whole[0][:2])
    assert dataclasses.is_dataclass(ss.batch_placement)
