"""The port's meshed stream and serving layers on the CPU (ROADMAP A8b):
a `StreamEngine` on a mesh of the ``cpu`` device under graph deltas,
refreshed until drained, held bitwise to the JAX package's
*single-device* stream (stale rows per delta, the store's live rows,
seeds, counter, influence); a bounded meshed stream against the
per-shard cap after every write; stream snapshots restored across
layouts both ways; `IMServer` synchronous against asynchronous over a
meshed stream; the small serving tier on a 2x2 mesh against the
unmeshed port; ``serve --mesh`` against the run without it; and the
column-blocked dense/pallas BFS against the unblocked port (bitwise,
``overlap`` on and off) and against JAX (the near-tie rule,
`repro_torch.core.ties`).  n <= 512, theta <= 4096, one torch thread;
tolerance: none but the near-tie rule where named."""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import stream as jst  # noqa: E402
from repro.core.engine import IMMConfig as JConfig  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch import stream as tst  # noqa: E402
from repro_torch.core import sampler as smp  # noqa: E402
from repro_torch.core import ties  # noqa: E402
from repro_torch.core.engine import IMMConfig, InfluenceEngine  # noqa: E402
from repro_torch.core.store import (  # noqa: E402
    ShardedStore, StorePressurePolicy,
)
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402

SAMPLERS = ("IC/sparse+stable", "LT/walk+stable", "WC/sparse+stable")
MESHES = (((2, 2), "equal", "auto"), ((1, 2), "balanced", "packed"),
          ((2, 1), "equal", "compressed"), ((2, 2), "balanced", "packed"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cpu_mesh(shape):
    return Mesh([["cpu"] * shape[1] for _ in range(shape[0])],
                ("data", "vertex"))


def _graphs(n=160, m=1200, seed=2):
    return (jgen.rmat_graph(n, m, seed=seed, weighted_ic="wc"),
            generators.rmat_graph(n, m, seed=seed, weighted_ic="wc"))


def _cfgs(sampler, store="auto", partition="equal", batch=48, seed=7):
    kw = dict(k=5, batch=batch, max_theta=4096, seed=seed, sampler=sampler,
              store=store)
    return JConfig(**kw), IMMConfig(partition=partition, **kw)


def _meshed(tg, cfg, shape, **kw):
    return tst.StreamEngine(tg, cfg, mesh=cpu_mesh(shape),
                            vertex_axis="vertex", **kw)


def _live_rows(store) -> list:
    st = store.state()
    R = np.asarray(st["R"])
    kind = str(np.asarray(st["kind"]))
    if kind == "packed":
        from repro_torch.core.pack.codec import unpack_bits_np
        R = unpack_bits_np(R, int(st["n"]))
    elif kind == "compressed":
        from repro_torch.core.pack.codec import token_decode_np
        R = token_decode_np(R, int(st["n"]))
    R = R[:int(st["count"])]
    if "live" in st:
        R = R[np.asarray(st["live"])[:int(st["count"])].astype(bool)]
    return sorted(map(bytes, np.asarray(R, np.uint8)))


def _same_stream(js, ts, k=5):
    assert ts.stale == js.stale and ts.theta == js.theta
    assert np.array_equal(ts.store.counter.numpy(),
                          np.asarray(js.store.counter))
    assert _live_rows(ts.store) == _live_rows(js.store)
    a, b = js.select(k), ts.select(k)
    np.testing.assert_array_equal(b.seeds, np.asarray(a.seeds))
    assert b.covered_frac == a.covered_frac and b.epoch == a.epoch
    sets = [list(np.asarray(a.seeds)[:2]), list(np.asarray(a.seeds))]
    np.testing.assert_array_equal(ts.influences(sets), js.influences(sets))


# ------------------------------------------ (i) the stream on a mesh ----

@pytest.mark.parametrize("sampler", SAMPLERS)
@pytest.mark.parametrize("shape,part,store", MESHES)
def test_meshed_stream_equals_the_jax_single_device_stream(sampler, shape,
                                                           part, store):
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(sampler, store, part)
    js = jst.StreamEngine(jg, jcfg)
    ts = _meshed(tg, tcfg, shape)
    assert isinstance(ts.store, ShardedStore)
    assert ts.engine.supports_row_resample
    js.extend(384)
    ts.extend(384)
    _same_stream(js, ts)
    for seed in range(3):
        d1 = jst.random_delta(js.graph, np.random.default_rng(30 + seed),
                              inserts=4, deletes=4, reweights=3)
        d2 = tst.random_delta(ts.graph, np.random.default_rng(30 + seed),
                              inserts=4, deletes=4, reweights=3)
        assert ts.apply_delta(d2) == js.apply_delta(d1)
        _same_stream(js, ts)
        if seed == 1:                       # a budgeted slice in between
            assert ts.refresh(budget=40) == js.refresh(budget=40)
            _same_stream(js, ts)
    assert ts.refresh() == js.refresh() == 0 and ts.consistent
    _same_stream(js, ts)
    # drained, it is a fresh meshed engine on the post-delta graph
    fresh = InfluenceEngine(ts.graph, ts.cfg, mesh=cpu_mesh(shape),
                            vertex_axis="vertex")
    fresh.extend(ts.theta)
    assert torch.equal(fresh.store.counter, ts.store.counter)
    np.testing.assert_array_equal(fresh.select(5).seeds, ts.select(5).seeds)


def test_balanced_blocks_stay_fixed_across_deltas():
    """The balanced vertex partition comes from the initial graph and
    stays through deltas (a snapshot restore re-partitions)."""
    _, tg = _graphs()
    _, cfg = _cfgs("IC/sparse+stable", "packed", "balanced")
    ts = _meshed(tg, cfg, (1, 2))
    part = ts.store.partition
    ts.extend(192)
    for seed in range(2):
        ts.apply_delta(tst.random_delta(ts.graph, np.random.default_rng(seed),
                                        inserts=30, deletes=2))
        ts.refresh()
    assert ts.store.partition is part and not part.is_equal


def test_meshed_stream_refuses_what_the_reference_refuses():
    _, tg = _graphs()
    with pytest.raises(ValueError, match="dense-at-rest"):
        _meshed(tg, IMMConfig(store="indices"), (2, 2))


# ---------------------------------------------- (ii) bounded on a mesh ----

@pytest.mark.parametrize("shape,store,policy", [
    ((2, 2), "auto", dict(max_rows=203)),
    ((2, 1), "packed", dict(max_rows=150)),
    ((4, 1), "packed", dict(max_bytes=64 * 200 - 1,
                            ladder=("compressed",))),
])
def test_bounded_meshed_stream_keeps_the_per_shard_cap(shape, store, policy):
    """After every add_batch and replace_rows each shard holds at most
    ``row_cap // D`` rows and capacity x row bytes stays within a byte
    cap; drained, the stream holds ``row_cap`` live rows whose sum is its
    counter."""
    _, tg = _graphs(n=512, m=2048)
    _, cfg = _cfgs("LT/walk+stable", store, batch=32)
    ts = _meshed(tg, cfg, shape, policy=StorePressurePolicy(**policy))
    st = ts.store
    writes = []

    def capped(write):
        def run(*a):
            out = write(*a)
            writes.append(write.__name__)
            assert max(st.counts) <= st.row_cap // st.D
            if "max_bytes" in policy:
                assert st.capacity * st._row_bytes() <= policy["max_bytes"]
            return out
        return run
    st.add_batch = capped(st.add_batch)
    st.replace_rows = capped(st.replace_rows)
    ts.extend(4096)
    ts.extend(4096)
    assert ts.theta == st.row_cap < 4096
    for seed in range(2):
        ts.apply_delta(tst.random_delta(ts.graph, np.random.default_rng(seed),
                                        inserts=6, deletes=6, reweights=6))
        ts.refresh()
    assert ts.stale == 0 and st.live_count == st.row_cap
    assert "add_batch" in writes and "replace_rows" in writes
    bits = np.stack([np.frombuffer(r, np.uint8) for r in _live_rows(st)])
    assert np.array_equal(st.counter.numpy(), bits.sum(axis=0))
    if policy.get("ladder"):
        assert st.representation == "compressed"


# ------------------------------------- (iii) restores across layouts ----

@pytest.mark.parametrize("src,dst", [((2, 2), None), (None, (2, 2)),
                                     ((2, 2), (1, 2)), ((1, 1), (2, 1))])
def test_stream_snapshot_restores_across_layouts(tmp_path, src, dst):
    """A drained stream's snapshot from one layout restored on another
    (none is a single-device store); the next delta repairs both to the
    same rows, with the same stale count."""
    _, tg = _graphs()
    _, cfg = _cfgs("IC/sparse+stable", "packed", "balanced")

    def make(shape, g):
        if shape is None:
            return tst.StreamEngine(g, cfg, device="cpu")
        return _meshed(g, cfg, shape)
    a = make(src, tg)
    a.extend(256)
    a.apply_delta(tst.random_delta(a.graph, np.random.default_rng(1),
                                   inserts=5, deletes=5))
    # drained first: a sharded snapshot keeps the live rows only, as the
    # reference's does, so a restore would top dead rows up with fresh
    # keys where the source repairs them with their own
    a.refresh()
    a.snapshot(str(tmp_path))
    b = make(dst, a.graph)
    assert b.restore(str(tmp_path))
    assert b.stale == a.stale and b.epoch == a.epoch
    assert _live_rows(b.store) == _live_rows(a.store)
    assert torch.equal(b.store.counter, a.store.counter)
    stale = [s.apply_delta(tst.random_delta(
        s.graph, np.random.default_rng(2), inserts=5, deletes=5,
        reweights=5)) for s in (a, b)]
    assert stale[0] == stale[1]
    for s in (a, b):
        s.refresh()
    assert _live_rows(b.store) == _live_rows(a.store)
    assert torch.equal(b.store.counter, a.store.counter)
    np.testing.assert_array_equal(a.select(5).seeds, b.select(5).seeds)


def test_a_meshed_snapshot_loads_in_the_jax_package(tmp_path):
    """The meshed stream's file is the reference's format: the JAX
    single-device stream resumes it and repairs the next delta to the
    same rows."""
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs("LT/walk+stable", "auto", "equal")
    ts = _meshed(tg, tcfg, (2, 2))
    ts.extend(256)
    ts.snapshot(str(tmp_path))
    js = jst.StreamEngine(jg, jcfg)
    assert js.restore(str(tmp_path))
    d1 = jst.random_delta(js.graph, np.random.default_rng(4), deletes=6)
    d2 = tst.random_delta(ts.graph, np.random.default_rng(4), deletes=6)
    assert ts.apply_delta(d2) == js.apply_delta(d1)
    assert ts.refresh() == js.refresh() == 0
    _same_stream(js, ts)


# ----------------------------------------------------- (iv) IMServer ----

def test_imserver_sync_and_async_agree_on_a_meshed_stream():
    """Once drained and refreshed: the async worker stops at ``stale ==
    0``, which (as in the reference) leaves dead rows while the live ones
    exceed the target (theta overshoots it by part of a batch here), so
    a last ``refresh()`` repairs those before the two are compared."""
    outs = []
    for async_refresh in (False, True):
        _, tg = _graphs()
        _, cfg = _cfgs("IC/sparse+stable", "packed", "balanced")
        ts = _meshed(tg, cfg, (2, 2))
        ts.extend(256)
        rng = np.random.default_rng(20)
        with tlaunch.IMServer(ts, max_batch=4, refresh_budget=48,
                              async_refresh=async_refresh) as server:
            probe = np.asarray(server.select(4).seeds)
            for _ in range(3):
                t0 = server.submit(probe)
                server.apply_delta(tst.random_delta(
                    ts.graph, rng, deletes=3, inserts=3, reweights=2))
                t1 = server.submit(probe)
                got = server.flush()
                assert got[t0] == got[t1]
            assert server.drain(timeout=60.0) and ts.stale == 0
        ts.refresh()
        assert ts.store.dead == 0
        with tlaunch.IMServer(ts, max_batch=4) as server:
            outs.append((server.influence(probe), server.served_epoch, ts))
    (sa, ea, a), (sb, eb, b) = outs
    assert sa == sb and ea == eb == 3
    assert torch.equal(a.store.counter, b.store.counter)
    np.testing.assert_array_equal(a.select(5).seeds, b.select(5).seeds)


def test_stale_ignores_dead_rows_past_the_target_as_the_reference_does():
    """A reference fault the port keeps (ROADMAP C): ``stale`` is the
    target theta less the live rows, so once theta overshot its target
    (extend stops at a batch boundary) dead rows within the overshoot are
    not stale: ``stale == 0`` (what the async worker and ``drain`` wait
    for) while rows are dead; ``refresh()`` still repairs them.  Both
    packages, single-device and meshed, alike."""
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs("IC/sparse+stable", batch=48)
    streams = (jst.StreamEngine(jg, jcfg),
               tst.StreamEngine(tg, tcfg, device="cpu"),
               _meshed(tg, tcfg, (2, 2)))
    out = []
    for s in streams:
        s.extend(256)                           # 6 batches: 288 rows
        P = jst if s is streams[0] else tst
        s.apply_delta(P.random_delta(s.graph, np.random.default_rng(3),
                                     deletes=1))
        out.append((s.store.count, s.store.dead, s.stale))
        s.refresh()
        assert s.store.dead == 0 and s.stale == 0
    assert out[0] == out[1] == out[2]
    count, dead, stale = out[0]
    assert count == 288 and 0 < dead <= 32 and stale == 0


# --------------------------------------------------- (v) the small tier ----

TIER_STORES = ({"store": "auto", "adaptive_representation": False,
                "selection_method": "fused-rebuild"},
               {"store": "packed"}, {"store": "auto"},
               {"store": "auto", "adaptive_representation": False,
                "selection_method": "rebuild"})


def _mix(n=256, theta=512):
    """The serving tier's five-tenant mix (``serve_tier``'s `_specs`: four
    R-MAT campaigns under WC, static and streaming alternating, tenant 2
    relaxed with replicas, tenant 4 a slot on tenant 0's engine), its
    stores and selections varied; "auto" is a bitmap store off a mesh
    and bitmap tiles on one (a mesh takes no single-device kind)."""
    specs = []
    for i, store in enumerate(TIER_STORES):
        cfg = IMMConfig(k=10, batch=max(theta // 4, 64),
                        max_theta=1 << 20, seed=i, sampler="IC/sparse",
                        **store)
        specs.append(tserve.TenantSpec(
            f"campaign-{i}", graph=generators.rmat_graph(
                n, 8 * n, seed=10 + i, weighted_ic="wc"),
            cfg=cfg, theta=theta, streaming=i % 2 == 1,
            slo="relaxed" if i == 2 else "strict",
            replicas=2 if i == 2 else 0, weight=2.0 if i == 0 else 1.0,
            max_pending=4096))
    specs.append(tserve.TenantSpec("campaign-4",
                                   share_engine_with="campaign-0",
                                   weight=0.5, max_pending=4096))
    return specs


def _replay(mesh_kwargs):
    """The mix's trace replayed synchronously (a refresh step after every
    pump): every ServedQuery but its latency, the stats and the tenants'
    selections."""
    tier = tserve.IMServe(quantum=8, refresh_budget=64, device="cpu",
                          mesh_kwargs=mesh_kwargs)
    for spec in _mix():
        tier.register(spec)
    graphs = {t.name: t.graph for t in tier.tenants.values()}
    streaming = {t.name: t.streaming and t.owns_engine
                 for t in tier.tenants.values()}
    events = tserve.make_trace(
        graphs, duration=1.0, qps=tserve.zipf_rates(
            sorted(graphs), 96.0 * len(graphs), 1.0,
            np.random.default_rng(0)),
        streaming=streaming, delta_period=0.25, delta_ops=4, seed=1)
    for e in events:
        if e.kind == tserve.KIND_DELTA:
            tier.apply_delta(e.tenant, e.delta)
        else:
            tier.try_submit(e.tenant, e.seeds)
        if tier.pending >= 16:
            tier.pump()
            tier.refresh_step()
    while tier.pending:
        tier.pump()
        tier.refresh_step()
    assert tier.drain(timeout=None)
    recs = [tuple(vars(tier.result(t)).values())[:6]
            for t in range(tier._next_ticket) if tier.result(t) is not None]
    return tier, dict(recs=recs, stats=tier.stats(), sels={
        n: [int(s) for s in tier.select(n, 10).seeds] for n in tier.tenants})


def test_the_small_tier_on_a_mesh_equals_the_unmeshed_port():
    """Every tenant engine on a 2x2 mesh of the host (balanced partition
    where a config asks; replicas meshed too): every ServedQuery but its
    latency, the stats and the selections equal the unmeshed replay; the
    meshed tenants share one dispatch lock."""
    _, want = _replay({})
    mesh = cpu_mesh((2, 2))
    tier, got = _replay({"mesh": mesh, "theta_axes": ("data",),
                         "vertex_axis": "vertex"})
    # the replica fan-out ships the store's snapshot tree, whose size is
    # its layout's: live rows compacted on a mesh, the arena off it
    shipped = [r["replicas"]["campaign-2"].pop("bytes_shipped")
               for r in (got["stats"], want["stats"])]
    assert shipped[0] > 0 and shipped[1] > 0
    assert got == want
    owners = [t for t in tier.tenants.values() if t.owns_engine]
    assert all(isinstance(t.engine.store, ShardedStore) for t in owners)
    assert len({id(t.lock) for t in tier.tenants.values()}) == 1
    assert tier.tenants["campaign-0"].lock is tier._mesh_lock
    group = tier.replica_groups["campaign-2"]
    primary = tier.tenants["campaign-2"].engine
    for rep in group.replicas:
        assert isinstance(rep.store, ShardedStore) and rep.mesh is mesh
        assert torch.equal(rep.store.counter, primary.store.counter)
        assert _live_rows(rep.store) == _live_rows(primary.store)


# ----------------------------------------------------------- (vi) CLI ----

@pytest.mark.parametrize("argv", [
    ["--workload", "im", "--graph", "com-Amazon", "--scale", "0.002",
     "--queries", "8", "--deltas", "2", "--model", "LT",
     "--max-theta", "512", "--k", "8"],
    ["--workload", "tier", "--tenants", "3", "--tier-n", "128",
     "--max-theta", "256", "--duration", "0.25", "--qps", "64",
     "--refresh-budget", "128", "--replicas", "1"],
])
def test_serve_mesh_cli_equals_the_run_without_it(argv):
    """``serve --mesh 2x2 --device cpu`` (a mesh of the host's one
    device: the tiled code path, 1x1) prints what the mesh-less run
    prints, but its timings and the worker's timing-moved fields."""
    runs = []
    for extra in ([], ["--mesh", "2x2"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = tlaunch.main(argv + extra + ["--device", "cpu"])
        runs.append((out, buf.getvalue().splitlines()))
    (a, la), (b, lb) = runs
    if argv[1] == "im":
        assert a == b
        assert lb[0].startswith("[serve-im] sharded store: theta axis "
                                "over 1 shard(s) x vertex axis over 1")
        assert la[1:] == lb[2:]
    else:
        assert a["drained"] and b["drained"]
        assert a["answered"].keys() == b["answered"].keys()
        assert lb[0] == la[0].replace("mesh=1", "mesh=2x2")
        assert lb[1] == la[1]


# ------------------------------------------- (vii) column-blocked BFS ----

def _placed_run(factory, g, cfg, shape, part=None):
    store = ShardedStore(g.n, mesh=cpu_mesh(shape), vertex_axis="vertex",
                         partition=part)
    return smp.bind_sampler(factory, g, cfg,
                            placement=store.batch_placement)


@pytest.mark.parametrize("name", ["IC/pallas", "IC/pallas+stable",
                                  "WC/pallas", "IC/dense",
                                  "GT/dense+stable"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (3, 2), (2, 3)])
def test_column_blocked_bfs_is_the_unblocked_port(name, shape):
    """Every row, the roots and the counter of a column-blocked batch are
    bitwise the unblocked port's, with overlap on and off and on equal
    and balanced blocks (on the host the overlap schedule is in line;
    the bits cannot depend on it)."""
    from repro_torch.graphs.partition import balanced_vertex_partition
    g = generators.rmat_graph(211, 1500, seed=4, weighted_ic="wc")
    factory = smp.get_sampler(name)
    for overlap in (False, True):
        cfg = IMMConfig(batch=21, overlap=overlap)
        full, counter, roots = factory(g, cfg)(prng.PRNGKey(9))
        for part in (None, balanced_vertex_partition(
                g.n, shape[1], dst=g.edge_dst.numpy())):
            blocks, counters, broots = _placed_run(
                factory, g, cfg, shape, part)(prng.PRNGKey(9))
            assert len(blocks) == shape[0]
            assert torch.equal(torch.cat(blocks), full)
            assert torch.equal(torch.cat(broots), roots)
            assert torch.equal(sum(counters), counter)


def test_column_forms_are_built_once_a_tile(monkeypatch):
    """The pallas form of each vertex block is built once per bound
    sampler per tile device (one device here: once a block), none at a
    step; a row subset runs unplaced, bitwise the batch's rows."""
    g = generators.rmat_graph(150, 900, seed=5)
    built = []
    real = smp.column_form
    monkeypatch.setattr(smp, "column_form",
                        lambda lq: built.append(lq.shape) or real(lq))
    cfg = IMMConfig(batch=12)
    factory = smp.get_sampler("IC/pallas+stable")
    sample = _placed_run(factory, g, cfg, (2, 3))
    assert [s[1] for s in built] == [50, 50, 50]
    for key in (1, 2):
        sample(prng.PRNGKey(key))
    assert len(built) == 3
    whole = factory(g, cfg)(prng.PRNGKey(3))[0]
    sub = sample(prng.PRNGKey(3), positions=np.array([11, 0, 5]))[0]
    assert torch.equal(sub, whole[[11, 0, 5]])


def test_pad_columns_of_a_balanced_block_never_activate():
    """A balanced block narrower than the tile width: the BFS samples
    only its live columns, and the store's pad columns stay zero."""
    from repro_torch.graphs.partition import balanced_vertex_partition
    g = generators.rmat_graph(180, 1400, seed=6)
    part = balanced_vertex_partition(g.n, 3, dst=g.edge_dst.numpy())
    assert len(set(int(x) for x in part.sizes)) > 1
    eng = InfluenceEngine(g, IMMConfig(batch=30, sampler="IC/pallas",
                                       partition="balanced", seed=2),
                          mesh=cpu_mesh((2, 3)), vertex_axis="vertex")
    eng.extend(120)
    st = eng.store
    for t in range(st.D):
        for v in range(st.Dv):
            assert not st.tile(t, v)[:, st.col_width[v]:].any()


@pytest.mark.parametrize("kernel,stable", [(True, False), (False, True)])
def test_column_blocked_bfs_against_jax_by_the_near_tie_rule(kernel,
                                                             stable):
    """Against JAX's unblocked dense loop (pallas in interpret mode, dense
    in XLA's order) on one key: every differing row is traced to its
    first differing cell, and each must be a near-tie (a coin within a
    few ulps of its threshold, `repro_torch.core.ties.classify_runs`)."""
    from repro.core import sampler as jsampler
    jg = jgen.rmat_graph(160, 1200, seed=8)
    g = generators.rmat_graph(160, 1200, seed=8)
    batch, n = 24, g.n
    logq = smp.logq_from_probs(g, smp._edge_probs(smp.IC, g))
    jl = jsampler.make_logq(jg)
    cpu = torch.device("cpu")
    starts = (0, 70, 113, n)                 # three unequal blocks
    tiles = []
    for c0, c1 in zip(starts[:-1], starts[1:]):
        lq = logq[:, c0:c1].contiguous()
        tiles.append((cpu, c0, c1, lq,
                      smp.column_form(lq) if kernel else None))
    key = prng.split(prng.PRNGKey(13), 2)[1]

    def run_port(t):
        return smp._dense_loop_tiled(
            key, tiles, batch=batch, n=n, home=cpu, rows=(0, batch),
            max_steps=t, stable=stable, kernel=kernel,
            overlap=True)[0].numpy()

    def run_ref(t):
        return np.asarray(jsampler._dense_loop(
            jnp.asarray(key), jl, batch=batch, max_steps=t, stable=stable,
            kernel=kernel, interpret=True)[0])

    v, c, r = smp._dense_loop_tiled(key, tiles, batch=batch, n=n, home=cpu,
                                    rows=(0, batch), stable=stable,
                                    kernel=kernel)
    jv, _, jr = jsampler._dense_loop(jnp.asarray(key), jl, batch=batch,
                                     stable=stable, kernel=kernel,
                                     interpret=True)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    assert torch.equal(c, v.sum(0, dtype=torch.int32))
    report = ties.classify_runs(
        run_ref, run_port,
        lambda t: smp.dense_coins(key, t, batch=batch, n_nodes=n,
                                  stable=stable).numpy(),
        logq.numpy(), r.numpy(), max_steps=n)
    same = (v.numpy() == np.asarray(jv)).all(axis=1)
    assert report["rows"] == int((~same).sum())
    assert report["faults"] == []
