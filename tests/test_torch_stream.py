"""Streaming in repro_torch against the JAX package on the CPU, bitwise:
the obs switch-off, GraphDelta application (all nine graph arrays),
``canonicalize`` and ``random_delta``; ``rows_touching`` on every store
kind; StreamEngine's refresh equivalence (IC/sparse+stable and
LT/walk+stable: a drained stream equals a fresh engine on the
post-delta graph, and every store state equals the reference stream's);
bounded streams; stream snapshots loaded across the packages; IMServer
ordering and epoch consistency, synchronous and with the async worker;
and the ``serve --workload im --deltas 2`` CLI."""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import stream as jst  # noqa: E402
from repro.core import store as jstore  # noqa: E402
from repro.core.engine import IMMConfig as JConfig  # noqa: E402
from repro.graphs import csr as jcsr  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import stream as tst  # noqa: E402
from repro_torch.core import store  # noqa: E402
from repro_torch.core.engine import IMMConfig, InfluenceEngine  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

GRAPH_FIELDS = ("src_offsets", "out_dst", "dst_offsets", "in_src",
                "in_prob", "in_lt_cum", "in_lt_total", "edge_src",
                "edge_dst")
SAMPLERS = ("IC/sparse+stable", "LT/walk+stable")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _graphs(n=96, m=768, seed=2):
    return (jgen.rmat_graph(n, m, seed=seed),
            generators.rmat_graph(n, m, seed=seed))


def _same_graph(jg, tg):
    assert (jg.n, jg.m) == (tg.n, tg.m)
    for f in GRAPH_FIELDS:
        a, b = np.asarray(getattr(jg, f)), getattr(tg, f).cpu().numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _same_state(js, ts):
    a, b = js.state(), ts.state()
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def _deltas(jg, tg, seed, **kw):
    """The same random delta drawn from each package's graph."""
    d1 = jst.random_delta(jg, np.random.default_rng(seed), **kw)
    d2 = tst.random_delta(tg, np.random.default_rng(seed), **kw)
    for f in ("src", "dst", "prob", "op"):
        assert np.array_equal(getattr(d1, f), getattr(d2, f))
    return d1, d2


# ------------------------------------------------------------------ obs --

def test_obs_disable_keeps_the_data_as_the_reference_does():
    for mod in (jobs, obs):
        mod.reset()
        mod.enable()
        mod.counter("x").add(2)
        mod.disable()
        mod.counter("x").add(5)
        assert not mod.enabled()
        assert mod.snapshot()["counters"] == {"x": 2}
        assert mod.get_metrics().snapshot()["counters"] == {"x": 2}
        mod.reset()
    assert obs.PHASES == jobs.PHASES and "refresh" in obs.PHASES


# ---------------------------------------------------------------- delta --

def test_canonicalize_matches_jax_and_is_idempotent():
    jg, tg = _graphs()
    jc, tc = jst.canonicalize(jg), tst.canonicalize(tg)
    _same_graph(jc, tc)
    _same_graph(jst.canonicalize(jc), tst.canonicalize(tc))
    _same_graph(jc, tst.canonicalize(tc))


@pytest.mark.parametrize("kw", [
    dict(inserts=6, deletes=6, reweights=6),
    dict(inserts=4, deletes=3, reweights=2, max_dst_indeg=4),
    dict(deletes=10), dict(inserts=10)])
def test_delta_apply_matches_jax(kw):
    jg, tg = (f(g) for f, g in zip((jst.canonicalize, tst.canonicalize),
                                   _graphs()))
    for seed in range(3):
        d1, d2 = _deltas(jg, tg, seed, **kw)
        np.testing.assert_array_equal(d1.touched_vertices(),
                                      d2.touched_vertices())
        jg, tg = d1.apply(jg), d2.apply(tg)
        _same_graph(jg, tg)


def test_delta_chained_ops_and_dense_apply_match_jax():
    jg, tg = (f(g) for f, g in zip((jst.canonicalize, tst.canonicalize),
                                   _graphs()))
    src, dst = np.asarray(jg.in_src), np.asarray(jg.edge_dst)
    # insert then reweight then delete one new edge, delete an old one
    u, v = 0, int(np.setdiff1d(np.arange(1, 96), dst[src == 0])[0])
    ops = dict(src=[u, u, u, src[3], u], dst=[v, v, v, dst[3], v],
               prob=[0.3, 0.7, 0.0, 0.0, 0.2], op=[0, 2, 1, 1, 0])
    d1, d2 = jst.GraphDelta(**ops), tst.GraphDelta(**ops)
    _same_graph(d1.apply(jg), d2.apply(tg))
    P = np.array(jcsr.dense_ic_matrix(jg))
    np.testing.assert_array_equal(np.asarray(d1.apply_dense(P)),
                                  d2.apply_dense(torch.from_numpy(P)).numpy())


@pytest.mark.parametrize("ops,match", [
    (dict(src=[0], dst=[0], prob=[0.5], op=[3]), "opcode"),
    (dict(src=[0], dst=[1], prob=[1.5], op=[0]), r"\[0, 1\]"),
    (dict(src=[0, 1], dst=[1], prob=[0.5], op=[0]), "one length")])
def test_delta_refuses_malformed_batches(ops, match):
    for mod in (jst, tst):
        with pytest.raises(ValueError, match=match):
            mod.GraphDelta(**ops)


def test_delta_apply_is_strict_as_the_reference():
    jg, tg = _graphs()
    src, dst = tg.in_src.numpy(), tg.edge_dst.numpy()
    missing = next((u, v) for u in range(96) for v in range(96)
                   if u != v and not ((src == u) & (dst == v)).any())
    cases = [(tst.GraphDelta.inserts([src[0]], [dst[0]], [0.5]), "existing"),
             (tst.GraphDelta.deletes([missing[0]], [missing[1]]), "missing"),
             (tst.GraphDelta.reweights([missing[0]], [missing[1]], [0.5]),
              "missing"),
             (tst.GraphDelta.deletes([0], [96]), "out of range")]
    for d, match in cases:
        with pytest.raises(ValueError, match=match):
            d.apply(tg)


# ----------------------------------------------------------- invalidate --

@pytest.mark.parametrize("kind", ["bitmap", "indices", "packed",
                                  "compressed"])
@pytest.mark.parametrize("verts", [[], [0], [3, 17, 17, 95], list(range(40))])
def test_rows_touching_and_invalidate_match_jax(kind, verts):
    rng = np.random.default_rng(len(verts))
    rows = (rng.random((40, 96)) < 0.06).astype(np.uint8)
    js = jstore.make_store(kind, 96)
    ts = store.make_store(kind, 96, device="cpu")
    js.add_batch(jnp.asarray(rows))
    ts.add_batch(torch.from_numpy(rows))
    want = np.asarray(jst.rows_touching(js, verts))
    got = tst.rows_touching(ts, verts)
    assert got.dtype == torch.bool and np.array_equal(want, got.numpy())
    assert np.array_equal(got.numpy()[:40],
                          rows[:, verts].any(axis=1) if verts else
                          np.zeros(40, bool))
    assert jst.invalidate(js, verts) == tst.invalidate(ts, verts)
    _same_state(js, ts)
    with pytest.raises(ValueError, match="out of range"):
        tst.rows_touching(ts, [96])


# --------------------------------------------------------------- stream --

def _stream_pair(sampler, store_kind="auto", policy=None, seed=7,
                 batch=64, max_theta=512, n=96, m=768):
    jg, tg = _graphs(n, m)
    kw = dict(k=5, batch=batch, max_theta=max_theta, seed=seed,
              sampler=sampler, store=store_kind)
    jp = jstore.StorePressurePolicy(**policy) if policy else None
    tp = store.StorePressurePolicy(**policy) if policy else None
    return (jst.StreamEngine(jg, JConfig(**kw), policy=jp),
            tst.StreamEngine(tg, IMMConfig(**kw), policy=tp, device="cpu"))


def _assert_stream_equals_fresh(stream, k=5):
    fresh = InfluenceEngine(stream.graph, stream.cfg, device="cpu")
    fresh.extend(stream.theta)
    a, b = stream.select(k), fresh.select(k)
    assert list(a.seeds) == list(b.seeds)
    assert a.covered_frac == b.covered_frac
    assert torch.equal(stream.store.counter, fresh.store.counter)
    assert np.array_equal(
        stream.influences([a.seeds[:2], a.seeds]),
        fresh.influences([a.seeds[:2], a.seeds]))


@pytest.mark.parametrize("sampler", SAMPLERS)
@pytest.mark.parametrize("store_kind", ["auto", "packed"])
def test_refresh_equivalence_matches_jax(sampler, store_kind):
    js, ts = _stream_pair(sampler, store_kind)
    assert ts.cfg.sampler == sampler and ts.engine.supports_row_resample
    js.extend(256)
    ts.extend(256)
    _same_state(js.store, ts.store)
    for seed in range(3):
        d1, d2 = _deltas(js.graph, ts.graph, 12 + seed, inserts=3,
                         deletes=3, reweights=2)
        assert js.apply_delta(d1) == ts.apply_delta(d2)
        _same_state(js.store, ts.store)
    assert js.stale == ts.stale
    assert js.refresh() == ts.refresh() == 0 and ts.consistent
    _same_state(js.store, ts.store)
    _assert_stream_equals_fresh(ts)


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_budgeted_refresh_matches_jax_slice_by_slice(sampler):
    js, ts = _stream_pair(sampler, batch=32)
    js.extend(256)
    ts.extend(256)
    d1, d2 = _deltas(js.graph, ts.graph, 15, inserts=4, deletes=4,
                     reweights=4)
    js.apply_delta(d1)
    ts.apply_delta(d2)
    backlog, steps = ts.stale, 0
    while ts.stale:
        left = ts.refresh(budget=48)
        assert js.refresh(budget=48) == left <= backlog
        _same_state(js.store, ts.store)
        backlog, steps = left, steps + 1
        assert steps < 64
    assert ts.last_repair == js.last_repair and \
        ts.rows_repaired == js.rows_repaired
    _assert_stream_equals_fresh(ts)


def test_epoch_tags_and_memo_follow_deltas():
    _, ts = _stream_pair("LT/walk+stable", batch=32)
    ts.extend(128)
    a = ts.select(3)
    assert a.epoch == 0 and a.stale == 0
    ts.apply_delta(tst.random_delta(ts.graph, np.random.default_rng(16),
                                    deletes=6))
    b = ts.select(3)
    assert b.epoch == 1 and b.stale > 0 and b.theta == ts.theta < a.theta
    ts.refresh()
    c = ts.select(3)
    assert c.epoch == 1 and c.stale == 0 and c.theta == 128


@pytest.mark.parametrize("store_kind", ["auto", "packed"])
def test_bounded_stream_matches_jax_and_keeps_its_cap(store_kind):
    js, ts = _stream_pair("LT/walk+stable", store_kind, dict(max_rows=200),
                          batch=64, max_theta=4096)
    js.extend(1024)
    ts.extend(1024)
    _same_state(js.store, ts.store)
    for seed in range(4):
        d1, d2 = _deltas(js.graph, ts.graph, 17 + seed, inserts=2,
                         deletes=2, reweights=2, max_dst_indeg=6)
        js.apply_delta(d1)
        ts.apply_delta(d2)
        assert js.refresh() == ts.refresh() == 0
        _same_state(js.store, ts.store)
        assert ts.store.capacity <= 200 and ts.theta == 200
    assert list(js.select(5).seeds) == list(ts.select(5).seeds)


def test_bounded_stream_steps_down_the_ladder_then_evicts():
    """Packed rows of 256 bytes fill 150 rows of the cap; the batch that
    overflows morphs the arena to (much shorter) token rows without an
    eviction; the row cap then binds at the token width, and the batches
    past it evict the oldest rows.  After every write the arena holds at
    most the cap's bytes."""
    n = 2048
    cap_bytes = 150 * 256
    _, ts = _stream_pair("LT/walk+stable", "packed",
                         dict(max_bytes=cap_bytes, ladder=("compressed",),
                              max_rows=300), batch=64, max_theta=4096, n=n,
                         m=8 * n)
    add = ts.store.add_batch

    def checked_add(*a):
        slots = add(*a)
        assert ts.store.capacity * ts.store._row_bytes() <= cap_bytes
        return slots
    ts.store.add_batch = checked_add
    obs.reset()
    obs.enable()
    try:
        ts.extend(150)
        assert ts.store.representation == "compressed"
        assert obs.snapshot()["counters"]["store.compress_steps"] == 1
        ts.extend(1024)
        counters = obs.snapshot()["counters"]
    finally:
        obs.reset()
    st = ts.store
    assert counters.get("store.rows_evicted", 0) > 0
    assert st.count == st.row_cap == ts.theta <= 300
    bits = st.codec.decode(st.R[:st.count])
    assert torch.equal(st.counter, bits.sum(dim=0, dtype=torch.int32))


def test_bounded_refresh_keeps_the_cap_after_every_write():
    """A refresh whose repair needs wider token rows: the store fits its
    byte cap inside that ``replace_rows`` (compacting the dead rows still
    owed and evicting the oldest), and the refresh follows the moved
    slots.  After every write the arena holds at most the cap's bytes;
    once drained, every live row is the one its recorded (batch,
    position) samples on the current graph."""
    g = generators.rmat_graph(256, 2048, seed=0)
    cfg = IMMConfig(k=3, batch=32, seed=1, store="compressed",
                    sampler="LT/walk+stable", max_theta=4096)
    cap_bytes = 64 * 32                     # 64 rows at s_pad 8
    ts = tst.StreamEngine(g, cfg, device="cpu",
                          policy=store.StorePressurePolicy(
                              max_bytes=cap_bytes))
    st = ts.store
    writes = []

    def checked(write):
        def run(*a):
            out = write(*a)
            writes.append((write.__name__, st.codec.s_pad, st.dead))
            assert st.capacity * st._row_bytes() <= cap_bytes
            return out
        return run
    st.add_batch = checked(st.add_batch)
    st.replace_rows = checked(st.replace_rows)
    ts.extend(64)
    assert st.codec.s_pad == 8 and ts.theta == 64
    stale = ts.apply_delta(tst.random_delta(
        ts.graph, np.random.default_rng(4), inserts=64, deletes=8,
        reweights=64))
    assert stale > 0
    del writes[:]
    assert ts.refresh() == 0 and ts.consistent
    # the widening write came while dead rows were still owed
    widened = [w for w in writes if w[0] == "replace_rows" and w[1] > 8]
    assert widened and widened[0][2] == 0
    assert writes[0][0] == "replace_rows" and writes[0][2] > 0
    assert st.dead == 0 and st.count == st.row_cap == ts.theta
    bits = st.codec.decode(st.R[:st.count])
    assert torch.equal(st.counter, bits.sum(dim=0, dtype=torch.int32))
    for slot in range(st.count):
        bid, pos = int(ts._slot_batch[slot]), int(ts._slot_pos[slot])
        row, _ = ts.engine.resample(ts._batch_keys[bid],
                                    positions=np.asarray([pos]))
        assert torch.equal(bits[slot], row[0].to(torch.uint8)), slot


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_stream_snapshot_loads_across_the_packages(tmp_path, writer):
    js, ts = _stream_pair("LT/walk+stable", "packed", batch=32)
    js.extend(256)
    ts.extend(256)
    d1, d2 = _deltas(js.graph, ts.graph, 21, inserts=3, deletes=3,
                     reweights=3)
    js.apply_delta(d1)
    ts.apply_delta(d2)
    js.refresh(budget=16)
    ts.refresh(budget=16)
    src = js if writer == "jax" else ts
    src.snapshot(str(tmp_path))
    kw = dict(k=5, batch=32, max_theta=512, seed=7,
              sampler="LT/walk+stable", store="packed")
    jr = jst.StreamEngine(js.graph, JConfig(**kw))
    tr = tst.StreamEngine(ts.graph, IMMConfig(**kw), device="cpu")
    assert jr.restore(str(tmp_path)) and tr.restore(str(tmp_path))
    _same_state(jr.store, tr.store)
    _same_state(js.store, tr.store)
    assert (tr.epoch, tr.stale, tr.target_theta) == (js.epoch, js.stale,
                                                     js.target_theta)
    d1, d2 = _deltas(jr.graph, tr.graph, 22, inserts=2, deletes=2,
                     reweights=2)
    jr.apply_delta(d1)
    tr.apply_delta(d2)
    assert jr.refresh() == tr.refresh() == 0
    _same_state(jr.store, tr.store)
    _assert_stream_equals_fresh(tr)


def test_stream_restore_refuses_another_sampler_batch_or_graph(tmp_path):
    _, ts = _stream_pair("LT/walk+stable", batch=32)
    ts.extend(64)
    ts.snapshot(str(tmp_path))
    g = ts.graph
    with pytest.raises(ValueError, match="sampled with"):
        tst.StreamEngine(g, IMMConfig(batch=32, sampler="IC/sparse"),
                         device="cpu").restore(str(tmp_path))
    with pytest.raises(ValueError, match="batch="):
        tst.StreamEngine(g, IMMConfig(batch=16, sampler="LT/walk+stable"),
                         device="cpu").restore(str(tmp_path))
    ts.apply_delta(tst.random_delta(g, np.random.default_rng(3), deletes=2))
    with pytest.raises(ValueError, match="different graph"):
        tst.StreamEngine(ts.graph, IMMConfig(batch=32,
                                             sampler="LT/walk+stable"),
                         device="cpu").restore(str(tmp_path))
    assert not tst.StreamEngine(g, IMMConfig(batch=32), device="cpu"
                                ).restore(str(tmp_path / "none"))


# ------------------------------------------------------------- IMServer --

def test_imserver_orders_results_across_chunks():
    _, tg = _graphs()
    engine = InfluenceEngine(tg, IMMConfig(k=4, batch=64, max_theta=256),
                             device="cpu")
    engine.extend(256)
    server = serve.IMServer(engine, max_batch=4)
    rng = np.random.default_rng(18)
    sets = [rng.choice(tg.n, size=s, replace=False)
            for s in (5, 1, 7, 2, 3, 1, 6, 4, 2, 5)]
    tickets = [server.submit(s) for s in sets]
    got = server.flush()
    assert server.pending == 0 and len(got) == len(sets)
    for t, w in zip(tickets, engine.influences(sets)):
        assert got[t] == float(w)


def _serve_through_deltas(server, stream, rounds=3, seed=20):
    probe = np.asarray(server.select(4).seeds)
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        t0 = server.submit(probe)
        server.apply_delta(tst.random_delta(stream.graph, rng, deletes=3,
                                            inserts=3, reweights=2))
        t1, t2 = server.submit(probe), server.submit(probe)
        got = server.flush()
        # one flush, one store state: no repair slice lands mid-flush
        assert got[t0] == got[t1] == got[t2]
    assert server.drain(timeout=60.0) and stream.stale == 0
    return probe


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_imserver_sync_and_async_refresh_agree(sampler):
    streams = []
    for async_refresh in (False, True):
        _, ts = _stream_pair(sampler, seed=3)
        ts.extend(256)
        with serve.IMServer(ts, max_batch=4, refresh_budget=64,
                            async_refresh=async_refresh) as server:
            assert server.async_refreshing == async_refresh
            probe = _serve_through_deltas(server, ts)
            assert server.served_epoch == 3
            sigma = server.influence(probe)
        assert not server.async_refreshing
        streams.append((ts, sigma))
    (a, sa), (b, sb) = streams
    assert sa == sb
    assert torch.equal(a.store.counter, b.store.counter)
    assert list(a.select(5).seeds) == list(b.select(5).seeds)
    _assert_stream_equals_fresh(b)


def test_imserver_refuses_what_the_reference_refuses():
    _, tg = _graphs()
    engine = InfluenceEngine(tg, IMMConfig(batch=32), device="cpu")
    with pytest.raises(ValueError, match="StreamEngine"):
        serve.IMServer(engine, refresh_budget=64)
    with pytest.raises(ValueError, match="StreamEngine"):
        serve.IMServer(engine).apply_delta(None)
    stream = tst.StreamEngine(tg, IMMConfig(batch=32), device="cpu")
    with pytest.raises(ValueError, match="refresh_budget"):
        serve.IMServer(stream, async_refresh=True)
    with pytest.raises(ValueError, match=">= 1"):
        serve.IMServer(stream, refresh_budget=0)
    with pytest.raises(ValueError, match=">= 1"):
        stream.refresh(budget=0)
    server = serve.IMServer(stream, refresh_budget=8)
    server.stop_refresh_worker()            # never started: a no-op
    server.close()


# ------------------------------------------------------------------ CLI --

def test_serve_im_cli_with_deltas_matches_jax():
    argv = ["--workload", "im", "--graph", "com-Amazon", "--scale", "0.002",
            "--queries", "16", "--deltas", "2", "--model", "LT",
            "--max-theta", "1024", "--k", "8"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jserve.main(argv)
    want = buf.getvalue().splitlines()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve.main(argv + ["--device", "cpu"])
    assert len(out["deltas"]) == 2 and out["final"][0]
    lines = buf.getvalue().splitlines()
    # the first line carries timings and the device; every other is equal
    assert len(lines) == len(want) and lines[1:] == want[1:]


def test_serve_cli_refuses_what_is_not_ported():
    """A meshed stream is ported (ROADMAP A8b): ``--mesh`` runs and, on
    the host's one device, prints the mesh-less run's lines after its own
    sharded-store line; what the reference refuses on a mesh (a store
    that is not dense at rest) the port refuses alike."""
    from repro_torch.mesh import Mesh
    argv = ["--workload", "im", "--graph", "com-Amazon", "--scale", "0.002",
            "--queries", "8", "--deltas", "1", "--max-theta", "256",
            "--device", "cpu"]
    outs = []
    for extra in ([], ["--mesh", "4"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = serve.main(argv + extra)
        outs.append((out, buf.getvalue().splitlines()))
    (a, la), (b, lb) = outs
    assert a == b
    assert lb[0].startswith("[serve-im] sharded store") and la[1:] == lb[2:]
    mesh = Mesh(["cpu"], ("data",))
    for P, kw in ((jst, {}), (tst, {"device": "cpu"})):
        g = _graphs()[0 if P is jst else 1]
        cfg = (JConfig if P is jst else IMMConfig)(store="indices")
        with pytest.raises(ValueError, match="dense-at-rest"):
            P.StreamEngine(g, cfg, mesh=(jax_mesh() if P is jst else mesh),
                           **kw)


def jax_mesh():
    import jax
    return jax.make_mesh((1,), ("data",))
