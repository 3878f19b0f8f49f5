"""The IMServe tier (`repro_torch.serve`) against the JAX package's
(`repro.serve`) on the CPU, on the same inputs: DRR rounds, admission
and the flood; cache keys, ``advance`` and the LRU; the refresh
scheduler's allocations (a hypothesis case over random backlogs and
weights); ``make_trace`` event for event, delta arrays included; replica
groups; the tier's routing, cache, epochs, shared slots and refresh; a
synchronous replay of a five-tenant mix (every `ServedQuery` but its
latency, ``stats()`` and the selections equal); the obs metrics after
the same run; the IMServe and IMServer lifecycles; ``serve --workload
tier``; and the thread-safe kernel launch counts.

Every engine uses the sparse sampler (its streams the ``+stable`` form),
so every answer is held bitwise.  Epoch consistency under a racing
refresh worker runs on the port alone (thread timing is not an input).
"""
import contextlib
import dataclasses
import io
import re
import sys
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro import stream as jst  # noqa: E402
from repro.checkpoint import store as jckpt  # noqa: E402
from repro.core.engine import IMMConfig as JConfig  # noqa: E402
from repro.core.engine import InfluenceEngine as JEngine  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.launch import serve as jlaunch  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch import stream as tst  # noqa: E402
from repro_torch.checkpoint import store as ckpt  # noqa: E402
from repro_torch.core.engine import IMMConfig, InfluenceEngine  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.kernels import _common  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402

SAMPLER = "IC/sparse"

JAX = types.SimpleNamespace(
    name="jax", serve=jserve, Config=JConfig, Engine=JEngine,
    rmat=jgen.rmat_graph, Stream=jst.StreamEngine,
    random_delta=jst.random_delta, ckpt=jckpt, obs=jobs,
    IMServer=jlaunch.IMServer, kw={})
TORCH = types.SimpleNamespace(
    name="torch", serve=tserve, Config=IMMConfig, Engine=InfluenceEngine,
    rmat=generators.rmat_graph, Stream=tst.StreamEngine,
    random_delta=tst.random_delta, ckpt=ckpt, obs=obs,
    IMServer=tlaunch.IMServer, kw={"device": "cpu"})


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def both(scenario):
    """Run ``scenario(pkg)`` on the reference and on the port; their
    records must be equal.  Returns the port's."""
    want, got = scenario(JAX), scenario(TORCH)
    assert got == want
    return got


def small_graph(P, seed=2):
    return P.rmat(96, 768, seed=seed)


def small_cfg(P, seed=0, theta=256, **kw):
    return P.Config(k=4, batch=64, max_theta=max(theta, 512), seed=seed,
                    sampler=SAMPLER, **kw)


def _tier(P, **kw):
    kw.setdefault("quantum", 4)
    return P.serve.IMServe(**kw, **P.kw)


def _spec(P, name, seed=2, **kw):
    kw.setdefault("graph", small_graph(P, seed))
    kw.setdefault("cfg", small_cfg(P, seed))
    kw.setdefault("theta", 256)
    return P.serve.TenantSpec(name, **kw)


def _engine(P, graph, cfg):
    return P.Engine(graph, cfg, **P.kw)


def _stream(P, seed=2):
    s = P.Stream(small_graph(P, seed), small_cfg(P), **P.kw)
    s.extend(256)
    return s


def _rec(r):
    """A `ServedQuery` without its latency (the one field timing sets)."""
    return dataclasses.astuple(r)[:6]


def _fl(x):
    return [float(v) for v in np.asarray(x)]


def _delta(P, tier, name, seed, **kw):
    return P.random_delta(tier.tenants[name].graph,
                          np.random.default_rng(seed), **kw)


# ------------------------------------------------- admission + fairness ----

def test_drr_weighted_rounds_and_no_hoarding():
    def scenario(P):
        S = P.serve
        q = S.DeficitRoundRobin(quantum=4)
        q.register("heavy", weight=2.0, max_pending=100)
        q.register("light", weight=1.0, max_pending=100)
        tid = iter(range(1000))
        for _ in range(20):
            q.submit(S.QueryTicket(next(tid), "heavy", np.array([1])))
        for _ in range(6):
            q.submit(S.QueryTicket(next(tid), "light", np.array([2])))
        rounds = []
        r1 = dict(q.take_round())
        assert len(r1["heavy"]) == 8 and len(r1["light"]) == 4
        r2 = dict(q.take_round())
        assert len(r2["heavy"]) == 8 and len(r2["light"]) == 2
        q.submit(S.QueryTicket(next(tid), "light", np.array([2])))
        r3 = dict(q.take_round())
        assert len(r3["light"]) == 1 and len(r3["heavy"]) == 4
        assert q.pending() == 0
        for r in (r1, r2, r3):
            rounds.append({k: [t.id for t in v] for k, v in r.items()})
        return rounds

    both(scenario)


def test_admission_rejects_at_cap_not_unbounded():
    def scenario(P):
        S = P.serve
        q = S.DeficitRoundRobin(quantum=4)
        q.register("t", weight=1.0, max_pending=3)
        admitted = [q.try_submit(S.QueryTicket(i, "t", np.array([i])))
                    for i in range(10)]
        assert admitted == [True] * 3 + [False] * 7
        with pytest.raises(S.AdmissionError, match="queue full"):
            q.submit(S.QueryTicket(99, "t", np.array([0])))
        served = [t.id for _, b in q.take_round() for t in b]
        return admitted, q.pending("t"), served, q.try_submit(
            S.QueryTicket(100, "t", np.array([0])))

    assert both(scenario)[-1]


def test_fairness_starvation_free_under_flood():
    """A light tenant behind a flooding one is served within its DRR
    bound, round for round as the reference serves it."""
    def scenario(P):
        S = P.serve
        q = S.DeficitRoundRobin(quantum=4)
        q.register("flood", weight=1.0, max_pending=10_000)
        q.register("light", weight=1.0, max_pending=10_000)
        tid = iter(range(10_000))
        for _ in range(400):
            q.submit(S.QueryTicket(next(tid), "flood", np.array([1])))
        for _ in range(10):
            q.submit(S.QueryTicket(next(tid), "light", np.array([2])))
        rounds = []
        while q.pending("light"):
            rounds.append([(n, len(b)) for n, b in q.take_round()])
        assert sum(k for r in rounds for n, k in r if n == "light") == 10
        assert len(rounds) <= -(-10 // 4)
        assert q.pending("flood") > 0
        return rounds

    both(scenario)


# ------------------------------------------------------------ result cache --

def test_cache_key_erases_seed_order_and_duplicates():
    for S in (jserve, tserve):
        k1 = S.ResultCache.key("t", 3, [3, 1, 3])
        assert k1 == S.ResultCache.key("t", 3, np.array([1, 3], np.int32))
        assert S.ResultCache.key("t", 4, [1, 3]) != k1
        assert S.ResultCache.key("u", 3, [1, 3]) != k1
    assert (tserve.ResultCache.key("t", 3, [3, 1, 3])
            == jserve.ResultCache.key("t", 3, [1, 3]))


def test_cache_advance_drops_exactly_the_old_epochs():
    def scenario(P):
        C = P.serve.ResultCache
        c = C(max_entries=64)
        for e in (0, 1):
            for s in range(4):
                c.put(C.key("a", e, [s]), float(10 * e + s))
        c.put(C.key("b", 0, [7]), 7.0)
        dropped = c.advance("a", 1)
        assert dropped == 4 and c.epochs("a") == {1}
        out = [dropped, c.invalidations, c.entries("a"), c.entries("b"),
               c.get(C.key("a", 0, [2])), c.get(C.key("a", 1, [2])),
               c.get(C.key("b", 0, [7])), c.advance("a", 1), c.stats()]
        assert out[4:8] == [None, 12.0, 7.0, 0]
        return out

    both(scenario)


def test_cache_lru_bound_and_hit_rate():
    def scenario(P):
        C = P.serve.ResultCache
        c = C(max_entries=3)
        for s in range(5):
            c.put(C.key("t", 0, [s]), float(s))
        out = [len(c), c.evictions, c.get(C.key("t", 0, [0])),
               c.get(C.key("t", 0, [4])), c.hit_rate]
        c.get(C.key("t", 0, [2]))
        c.put(C.key("t", 0, [5]), 5.0)
        c.put(C.key("t", 0, [6]), 6.0)
        out += [c.get(C.key("t", 0, [2])), c.get(C.key("t", 0, [3])),
                c.stats()]
        assert out[:4] == [3, 2, None, 4.0] and 0 < out[4] < 1
        assert out[5] == 2.0 and out[6] is None
        return out

    both(scenario)


# ------------------------------------------------------- refresh scheduler --

def _grants(allocs):
    return [(a.tenant, a.budget, a.backlog) for a in allocs]


def test_scheduler_allocates_proportional_to_weighted_backlog():
    def scenario(P):
        s = P.serve.RefreshScheduler(budget=100)
        a = _grants(s.allocate({"a": 300, "b": 100, "idle": 0}))
        assert a == [("a", 75, 300), ("b", 25, 100)]
        b = _grants(s.allocate({"a": 100, "b": 100}, {"a": 3.0, "b": 1.0}))
        assert [g[1] for g in b] == [75, 25]
        return a, b, s.steps, s.rows_granted

    assert both(scenario)[2:] == (2, 200)


def test_scheduler_floor_caps_and_small_budget():
    def scenario(P):
        s = P.serve.RefreshScheduler(budget=10)
        out = [_grants(s.allocate(b)) for b in (
            {"a": 3, "b": 100}, {"a": 1, "b": 1000}, {"a": 2, "b": 3},
            {"a": 0}, {"c": 1, "a": 1, "b": 1, "d": 1})]
        assert dict((t, g) for t, g, _ in out[0])["a"] <= 3
        assert dict((t, g) for t, g, _ in out[1])["a"] >= 1
        assert sum(g for _, g, _ in out[2]) == 5 and out[3] == []
        with pytest.raises(ValueError, match=">= 1"):
            P.serve.RefreshScheduler(0)
        return out

    both(scenario)


def test_scheduler_matches_reference_on_random_backlogs():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies
    names = st.sampled_from(["a", "b", "c", "d", "e", "f"])

    @hyp.settings(max_examples=300, deadline=None)
    @hyp.given(backlogs=st.dictionaries(names, st.integers(0, 5000),
                                        max_size=6),
               weights=st.dictionaries(names, st.floats(0.1, 8.0),
                                       max_size=6),
               budget=st.integers(1, 2048))
    def check(backlogs, weights, budget):
        js = jserve.RefreshScheduler(budget)
        ts = tserve.RefreshScheduler(budget)
        got = _grants(ts.allocate(backlogs, weights))
        assert got == _grants(js.allocate(backlogs, weights))
        assert sum(g for _, g, _ in got) == min(
            budget, sum(b for b in backlogs.values() if b > 0))
        assert all(0 < g <= b for _, g, b in got)
        assert ts.rows_granted == js.rows_granted

    check()


# ------------------------------------------------------ stream accounting --

def test_stream_engine_repair_accounting():
    def scenario(P):
        stream = _stream(P)
        out = [stream.refreshes, stream.rows_repaired, stream.backlog]
        stream.apply_delta(P.random_delta(
            stream.graph, np.random.default_rng(5), deletes=4))
        backlog = stream.backlog
        assert backlog == stream.stale > 0
        stream.refresh()
        out += [backlog, stream.backlog, stream.refreshes,
                stream.rows_repaired, stream.last_repair]
        assert out[-3:] == [1, backlog, backlog]
        return out

    both(scenario)


# -------------------------------------------------- snapshot fan-out bits --

def test_clone_tree_deep_copies_and_tree_bytes():
    def scenario(P):
        eng = _engine(P, small_graph(P), small_cfg(P))
        eng.extend(256)
        tree = eng.snapshot_tree()
        clone = P.ckpt.clone_tree(tree)
        assert P.ckpt.tree_bytes(clone) == P.ckpt.tree_bytes(tree) > 0
        _, leaves = P.ckpt._flatten(clone)
        _, orig = P.ckpt._flatten(tree)
        k = "store/R"
        before = np.array(orig[k])
        np.asarray(leaves[k])[...] = 0          # mutate the clone...
        np.testing.assert_array_equal(np.asarray(orig[k]), before)  # only
        return P.ckpt.tree_bytes(tree), sorted(leaves)

    both(scenario)


def test_engine_replicate_is_bitwise_and_independent():
    sets = [np.array([1, 5], np.int32), np.array([7], np.int32)]

    def scenario(P):
        eng = _engine(P, small_graph(P), small_cfg(P))
        eng.extend(256)
        rep = eng.replicate()
        assert rep is not eng
        got = _fl(rep.influences(sets))
        assert got == _fl(eng.influences(sets))
        eng.extend(512)                         # the replica does not move
        assert _fl(rep.influences(sets)) == got
        return got, _fl(np.asarray(rep.store.counter)), rep.theta

    both(scenario)


def test_replica_group_serves_only_after_sync_and_tracks_epochs():
    probe = [np.array([3, 9], np.int32)]

    def scenario(P):
        stream = _stream(P)
        group = P.serve.ReplicaGroup(stream, 2)
        assert not group.servable
        with pytest.raises(RuntimeError, match="sync"):
            group.influences([np.array([1], np.int32)])
        out = [group.sync(stream.epoch)]
        want = _fl(stream.influences(probe))
        out += [_fl(group.influences(probe)) for _ in range(2)]
        assert out[1] == out[2] == want
        stream.apply_delta(P.random_delta(
            stream.graph, np.random.default_rng(6), deletes=3))
        stream.refresh()
        assert group.synced_epoch == 0 and stream.epoch == 1
        out.append(group.sync(stream.epoch))
        assert group.syncs == 2 and group.bytes_shipped > 0
        out.append(_fl(group.influences(probe)))
        assert out[-1] == _fl(stream.influences(probe))
        out.append(group.stats())
        return out

    both(scenario)


# ------------------------------------------------------------- tier: cache --

def test_tier_cached_sigma_is_bitwise_identical():
    seeds = np.array([3, 11, 40], np.int32)

    def scenario(P):
        tier = _tier(P)
        tier.register(_spec(P, "a"))
        t1 = tier.submit("a", seeds)
        tier.flush()
        t2 = tier.submit("a", seeds[::-1])      # same set, other order
        tier.flush()
        r1, r2 = tier.result(t1), tier.result(t2)
        assert not r1.cached and r2.cached and r2.value == r1.value
        with tier.tenants["a"].lock:
            direct = _fl(tier.tenants["a"].engine.influences([seeds]))[0]
        assert r1.value == direct
        return _rec(r1), _rec(r2), tier.stats()

    both(scenario)


def test_tier_cache_entries_never_survive_epoch_advance():
    probe = np.array([2, 17], np.int32)

    def scenario(P):
        tier = _tier(P, refresh_budget=512)
        tier.register(_spec(P, "s", streaming=True))
        rng = np.random.default_rng(7)
        recs = []
        for _ in range(3):
            ts = [tier.submit("s", probe),
                  tier.submit("s", rng.choice(96, size=4, replace=False))]
            tier.flush()
            assert tier.cache.epochs("s") == {
                tier.tenants["s"].served_epoch}
            recs += [_rec(tier.result(t)) for t in ts]
            tier.apply_delta("s", P.random_delta(
                tier.tenants["s"].graph, rng, inserts=2, deletes=2))
            assert tier.drain(timeout=60.0)
        t = tier.submit("s", probe)
        tier.flush()
        assert tier.cache.epochs("s") == {3}
        assert tier.result(t).epoch == 3 and not tier.result(t).cached
        assert tier.cache.invalidations > 0
        return recs + [_rec(tier.result(t))], tier.stats()

    both(scenario)


def test_tier_mid_repair_answers_bypass_cache():
    probe = np.array([4, 21, 50], np.int32)

    def scenario(P):
        tier = _tier(P, refresh_budget=512)
        tier.register(_spec(P, "s", streaming=True))
        tier.submit("s", probe)
        tier.flush()
        assert tier.cache.entries("s") == 1
        tier.apply_delta("s", _delta(P, tier, "s", 17, deletes=4,
                                     inserts=4))
        assert tier.tenants["s"].backlog > 0
        ts = [tier.submit("s", probe)]
        tier.flush()
        ts.append(tier.submit("s", probe))
        tier.flush()
        assert tier.cache.entries("s") == 0
        assert tier.drain(timeout=60.0)
        for _ in range(2):
            ts.append(tier.submit("s", probe))
            tier.flush()
        recs = [_rec(tier.result(t)) for t in ts]
        assert [r[4] for r in recs] == [False, False, False, True]
        assert recs[3][2] == recs[2][2]
        return recs, tier.stats()

    both(scenario)


def test_tier_shared_engine_slot():
    seeds = np.array([5, 23], np.int32)

    def scenario(P):
        tier = _tier(P)
        tier.register(_spec(P, "host"))
        tier.register(P.serve.TenantSpec("guest", share_engine_with="host"))
        guest = tier.tenants["guest"]
        assert not guest.owns_engine
        assert guest.engine is tier.tenants["host"].engine
        assert guest.lock is tier.tenants["host"].lock
        t1, t2 = tier.submit("host", seeds), tier.submit("guest", seeds)
        tier.flush()
        r1, r2 = tier.result(t1), tier.result(t2)
        assert r1.value == r2.value and not (r1.cached or r2.cached)
        assert guest.stats()["shared_engine"]
        with pytest.raises(ValueError, match="unknown tenant"):
            tier.register(P.serve.TenantSpec("x", share_engine_with="nobody"))
        return _rec(r1), _rec(r2), tier.stats()

    both(scenario)


def test_tier_admission_and_error_paths():
    def scenario(P):
        S = P.serve
        tier = _tier(P)
        tier.register(_spec(P, "a", max_pending=2))
        got = [tier.try_submit("a", [v]) for v in (1, 2, 3)]
        assert got[2] is None
        with pytest.raises(S.AdmissionError, match="queue full"):
            tier.submit("a", [4])
        assert tier.tenants["a"].rejected == 2
        answers = tier.flush()
        with pytest.raises(ValueError, match="streaming"):
            tier.apply_delta("a", None)
        with pytest.raises(KeyError, match="unknown tenant"):
            tier.submit("ghost", [1])
        with pytest.raises(ValueError, match="already registered"):
            tier.register(_spec(P, "a"))
        for bad, match in ((dict(slo="gold"), "slo"),
                           (dict(weight=0.0), "weight"),
                           (dict(max_pending=0), "max_pending"),
                           (dict(latency_slo_ms=-1.0), "latency_slo_ms")):
            with pytest.raises(ValueError, match=match):
                S.TenantSpec("bad", graph=small_graph(P), **bad)
        with pytest.raises(ValueError, match="needs a graph"):
            S.TenantSpec("bad2")
        with pytest.raises(ValueError, match="streaming=True"):
            tier.register(_spec(P, "p", policy=object()))
        return got, {k: float(v) for k, v in answers.items()}, tier.stats()

    both(scenario)


# ---------------------------------------------------------- tier: replicas --

def test_tier_relaxed_slo_routes_to_replicas():
    seeds = np.array([4, 9], np.int32)

    def scenario(P):
        tier = _tier(P)
        tier.register(_spec(P, "strict"))
        tier.register(_spec(P, "relax", seed=3, slo="relaxed", replicas=2))
        t1, t2 = tier.submit("strict", seeds), tier.submit("relax", seeds)
        t3 = tier.submit("relax", seeds)
        tier.flush()
        assert not tier.result(t1).replica and tier.result(t2).replica
        assert tier.tenants["relax"].replica_reads == 2
        with tier.tenants["relax"].lock:
            want = _fl(tier.tenants["relax"].engine.influences([seeds]))[0]
        assert tier.result(t2).value == want
        sel = tier.select("relax", 3)
        assert list(sel.seeds) == list(tier.tenants["relax"].engine
                                       .select(3).seeds)
        return ([_rec(tier.result(t)) for t in (t1, t2, t3)],
                [int(s) for s in sel.seeds], tier.stats())

    both(scenario)


def test_tier_replicas_resync_only_at_consistent_epochs():
    def scenario(P):
        tier = _tier(P, refresh_budget=512)
        tier.register(_spec(P, "r", streaming=True, slo="relaxed",
                            replicas=1))
        group = tier.replica_groups["r"]
        assert group.synced_epoch == 0
        tier.apply_delta("r", _delta(P, tier, "r", 9, deletes=3,
                                     inserts=3))
        assert tier.tenants["r"].backlog > 0
        assert tier.sync_replicas() == 0 and group.synced_epoch == 0
        assert tier.drain(timeout=60.0)
        assert group.synced_epoch == tier.tenants["r"].epoch == 1
        t = tier.submit("r", [1, 2])
        tier.flush()
        assert tier.result(t).replica and tier.result(t).epoch == 1
        return _rec(tier.result(t)), tier.stats()

    both(scenario)


# ----------------------------------------------- tier: refresh scheduling --

def test_tier_refresh_step_spends_budget_where_deltas_landed():
    def scenario(P):
        tier = _tier(P, refresh_budget=16)
        tier.register(_spec(P, "hot", streaming=True))
        tier.register(_spec(P, "cold", seed=4, streaming=True))
        tier.register(_spec(P, "static", seed=5))
        tier.apply_delta("hot", _delta(P, tier, "hot", 11, deletes=4,
                                       inserts=4))
        allocs = _grants(tier.refresh_step())
        assert {a[0] for a in allocs} == {"hot"}
        assert sum(a[1] for a in allocs) <= 16
        assert tier.drain(timeout=60.0) and tier.backlog == 0
        hot = tier.tenants["hot"]
        fresh = _engine(P, hot.graph, hot.engine.cfg)
        fresh.extend(hot.engine.theta)
        counter = _fl(np.asarray(hot.engine.store.counter))
        assert counter == _fl(np.asarray(fresh.store.counter))
        return allocs, counter, tier.stats()

    both(scenario)


def test_tier_refresh_requires_budget():
    for P in (JAX, TORCH):
        tier = _tier(P)
        with pytest.raises(ValueError, match="refresh_budget"):
            tier.refresh_step()
        with pytest.raises(ValueError, match="refresh_budget"):
            tier.start_refresh_worker()
    # a meshed tier (ROADMAP A8b) builds its tenants on the mesh
    from repro_torch.mesh import Mesh
    mesh = Mesh([["cpu"] * 2] * 2, ("data", "vertex"))
    tier = tserve.IMServe(mesh_kwargs={"mesh": mesh, "vertex_axis": "vertex"},
                          device="cpu")
    assert tier.device.type == "cpu" and tier.mesh_kwargs["mesh"] is mesh
    assert tserve.IMServe(mesh_kwargs={}, device="cpu").device.type == "cpu"


# ------------------------------------------------- epoch consistency race --

def test_tier_queries_stay_epoch_consistent_under_racing_refresh():
    """The port alone: queries race the refresh worker and a delta
    thread; each DRR batch is answered under the tenant lock against one
    store state (identical sets, identical values, one epoch), and after
    the drain a cache hit equals a fresh engine bitwise."""
    P = TORCH
    tier = _tier(P, refresh_budget=32)
    tier.register(_spec(P, "s", streaming=True))
    probe = np.array([8, 33, 60], np.int32)
    batches, errors = [], []
    stop = threading.Event()

    def mutate():
        rng = np.random.default_rng(13)
        try:
            while not stop.is_set():
                tier.apply_delta("s", P.random_delta(
                    tier.tenants["s"].graph, rng, inserts=2, deletes=2))
                time.sleep(0.002)
        except Exception as e:                # pragma: no cover
            errors.append(e)

    with tier:
        tier.start_refresh_worker()
        mut = threading.Thread(target=mutate)
        mut.start()
        try:
            for _ in range(10):
                batch = [tier.submit("s", probe) for _ in range(3)]
                tier.flush()
                batches.append(batch)
        finally:
            stop.set()
            mut.join(timeout=60)
        assert not mut.is_alive()
        assert tier.drain(timeout=60.0)
    assert not tier.refreshing and not errors
    for batch in batches:
        recs = [tier.result(t) for t in batch]
        assert all(r is not None and r.tenant == "s" for r in recs)
        assert len({r.value for r in recs}) == 1, "torn read in one batch"
        assert len({r.epoch for r in recs}) == 1
    s = tier.tenants["s"]
    fresh = _engine(P, s.graph, s.engine.cfg)
    fresh.extend(s.engine.theta)
    t1 = tier.submit("s", probe)
    tier.flush()
    t2 = tier.submit("s", probe)
    tier.flush()
    assert tier.result(t1).value == _fl(fresh.influences([probe]))[0]
    assert tier.result(t2).cached
    assert tier.result(t2).value == tier.result(t1).value


# -------------------------------------------------------- trace generator --

def _events(evs):
    out = []
    for e in evs:
        rec = [e.t, e.tenant, e.kind]
        if e.seeds is not None:
            rec.append(("seeds", e.seeds.dtype.str, e.seeds.tolist()))
        if e.delta is not None:
            rec.append(tuple((f, getattr(e.delta, f).dtype.str,
                              getattr(e.delta, f).tolist())
                             for f in ("src", "dst", "prob", "op")))
        out.append(rec)
    return out


def test_make_trace_matches_jax_event_for_event():
    def scenario(P):
        graphs = {"a": small_graph(P, 2), "b": small_graph(P, 3),
                  "c": small_graph(P, 4)}
        kw = dict(duration=0.5, qps=P.serve.zipf_rates(
            sorted(graphs), 240.0, 1.0, np.random.default_rng(0)),
            streaming={"b": True, "c": True}, delta_period=0.2, seed=4)
        t1 = _events(P.serve.make_trace(graphs, **kw))
        assert t1 == _events(P.serve.make_trace(graphs, **kw))
        assert [e[0] for e in t1] == sorted(e[0] for e in t1)
        s = P.serve.trace_summary(P.serve.make_trace(graphs, **kw))
        assert s["b"]["deltas"] == 2 and s["a"]["deltas"] == 0
        assert s["a"]["queries"] > 0
        rates = P.serve.zipf_rates(["a", "b", "c"], 90.0, 1.0,
                                   np.random.default_rng(0))
        assert sum(rates.values()) == pytest.approx(90.0)
        assert max(rates.values()) > min(rates.values())
        return t1, s, rates, P.serve.KIND_QUERY, P.serve.KIND_DELTA

    both(scenario)


def test_replay_answers_admitted_queries_and_counts_rejections():
    def scenario(P):
        tier = _tier(P)
        tier.register(_spec(P, "a", max_pending=2))
        events = P.serve.make_trace({"a": tier.tenants["a"].graph},
                                    duration=0.5, qps=40.0, seed=5)
        answered, rejected = P.serve.replay(tier, events, pump_every=2)
        n_queries = P.serve.trace_summary(events)["a"]["queries"]
        assert len(answered) + rejected == n_queries and answered
        for tid, val in answered.items():
            assert tier.result(tid).value == val
        return ({k: float(v) for k, v in answered.items()}, rejected,
                tier.stats())

    both(scenario)


# ---------------------------------------- the five-tenant mix, replayed --

def mix_specs(P, n=256, theta=512, replicas=2, max_pending=4096):
    """The serving tier's tenant mix (the reference's ``serve_tier``
    bench: R-MAT campaigns with WC weights, alternating static and
    streaming, tenant 2 relaxed with replicas, tenant 4 a slot on tenant
    0's engine at weight 0.5), its stores varied so every store kind
    the tier serves is crossed."""
    stores = ({"store": "bitmap", "adaptive_representation": False,
               "selection_method": "fused-rebuild"},
              {"store": "packed"}, {"store": "auto"},
              {"store": "bitmap", "adaptive_representation": False,
               "selection_method": "rebuild"})
    specs = []
    for i in range(4):
        cfg = P.Config(k=10, batch=max(theta // 4, 64),
                       max_theta=max(theta, 1 << 20), seed=i,
                       sampler=SAMPLER, **stores[i])
        specs.append(P.serve.TenantSpec(
            f"campaign-{i}", graph=P.rmat(n, 8 * n, seed=10 + i,
                                          weighted_ic="wc"),
            cfg=cfg, theta=theta, streaming=i % 2 == 1,
            slo="relaxed" if i == 2 else "strict",
            replicas=replicas if i == 2 else 0,
            weight=2.0 if i == 0 else 1.0, max_pending=max_pending))
    specs.append(P.serve.TenantSpec("campaign-4",
                                    share_engine_with="campaign-0",
                                    weight=0.5, max_pending=max_pending))
    return specs


def sync_replay(tier, events, pump_every=16):
    """`replay` with a `refresh_step` after every pump (no worker), so a
    run is a function of the trace alone."""
    from repro_torch.serve import KIND_DELTA

    rejected = 0
    for e in events:
        if e.kind == KIND_DELTA:
            tier.apply_delta(e.tenant, e.delta)
        elif tier.try_submit(e.tenant, e.seeds) is None:
            rejected += 1
        if tier.pending >= pump_every:
            tier.pump()
            tier.refresh_step()
    while tier.pending:
        tier.pump()
        tier.refresh_step()
    assert tier.drain(timeout=None)
    return rejected


def run_mix(P, *, qps=96.0, duration=1.0, **spec_kw):
    tier = P.serve.IMServe(quantum=8, refresh_budget=64, **P.kw)
    for spec in mix_specs(P, **spec_kw):
        tier.register(spec)
    graphs = {t.name: t.graph for t in tier.tenants.values()}
    streaming = {t.name: t.streaming and t.owns_engine
                 for t in tier.tenants.values()}
    events = P.serve.make_trace(
        graphs, duration=duration, qps=P.serve.zipf_rates(
            sorted(graphs), qps * len(graphs), 1.0,
            np.random.default_rng(0)),
        streaming=streaming, delta_period=duration / 4, delta_ops=4,
        seed=1)
    rejected = sync_replay(tier, events)
    recs = [_rec(tier.result(t)) for t in range(tier._next_ticket)
            if tier.result(t) is not None]
    sels = {name: [int(s) for s in tier.select(name, 10).seeds]
            for name in tier.tenants}
    epochs = {name: sorted(tier.cache.epochs(name)) for name in tier.tenants}
    return tier, dict(events=_events(events), rejected=rejected,
                      recs=recs, stats=tier.stats(), sels=sels,
                      epochs=epochs)


def test_tier_sync_replay_of_the_mix_matches_jax():
    """Every ServedQuery (value, epoch, cached and replica flags), the
    stats, the cache's epochs and every tenant's selection after a
    synchronous replay of the five-tenant mix, equal to the reference's;
    both replicas hold the primary's store bitwise."""
    want = run_mix(JAX)[1]
    tier, got = run_mix(TORCH)
    assert got == want
    flags = {(r[4], r[5]) for r in got["recs"]}
    assert (True, False) in flags and (False, True) in flags
    assert any(r[3] > 0 for r in got["recs"])           # served past deltas
    primary = tier.tenants["campaign-2"].engine
    for rep in tier.replica_groups["campaign-2"].replicas:
        assert torch.equal(rep.store.R, primary.store.R)
        assert torch.equal(rep.store.counter, primary.store.counter)


def test_tier_obs_metrics_match_jax_after_the_same_run():
    """The obs catalog's serve and stream series after the same run:
    the same names, counter values and histogram counts."""
    def scenario(P):
        P.obs.reset()
        P.obs.enable()
        try:
            tier = P.serve.IMServe(quantum=4, refresh_budget=32, **P.kw)
            tier.register(_spec(P, "s", streaming=True, slo="relaxed",
                                replicas=1, latency_slo_ms=1e-9))
            tier.register(_spec(P, "a", seed=3, max_pending=2))
            for i in range(3):
                for seeds in ([1, 2, 3], [4, 5], [3, 2, 1]):
                    tier.try_submit("a", seeds)     # the third is refused
                tier.submit("s", [1, 2])
                tier.pump()
                tier.apply_delta("s", _delta(P, tier, "s", 30 + i,
                                             deletes=3, inserts=3))
                tier.flush()
                tier.refresh_step()
            assert tier.drain(timeout=None)
            snap = tier.metrics()
        finally:
            P.obs.disable()
            P.obs.reset()
        serve = {k: v for k, v in snap["counters"].items()
                 if k.startswith(("serve.", "stream."))}
        gauges = {k: v for k, v in snap["gauges"].items()
                  if k.startswith("serve.")}
        hists = {k: v["count"] for k, v in snap["histograms"].items()}
        return serve, gauges, hists

    serve, gauges, hists = both(scenario)
    for name in ("serve.rejected{tenant=a}", "serve.drr_rounds",
                 "serve.cache_hits{tenant=a}", "serve.cache_misses{tenant=a}",
                 "serve.slo_violations{tenant=s}", "stream.deltas"):
        assert serve.get(name, 0) > 0, name
    assert "serve.queue_depth{tenant=a}" in gauges
    assert hists["serve.replica_sync_ms"] >= 2
    assert set(hists) >= {"serve.latency_ms{tenant=a}",
                          "serve.latency_ms{tenant=s}"}


# ------------------------------------------------------ lifecycle: IMServe --

def test_imserve_lifecycle_idempotent_and_restartable():
    def scenario(P):
        tier = _tier(P, refresh_budget=64)
        tier.register(_spec(P, "s", streaming=True))
        tier.start_refresh_worker()
        tier.start_refresh_worker()             # idempotent
        states = [tier.refreshing]
        tier.stop_refresh_worker()
        tier.stop_refresh_worker()              # safe twice
        states.append(tier.refreshing)
        tier.start_refresh_worker()             # restartable
        states.append(tier.refreshing)
        tier.close()
        with tier:
            tier.start_refresh_worker()
        states.append(tier.refreshing)          # __exit__ stopped it
        tier.close()
        assert states == [True, False, True, False]
        return states, tier.stats()

    assert both(scenario)[1]["refresh"]["budget"] == 64


def test_imserve_drain_inline_without_worker_and_timeout():
    def scenario(P):
        tier = _tier(P, refresh_budget=8)
        tier.register(_spec(P, "s", streaming=True))
        tier.apply_delta("s", _delta(P, tier, "s", 15, deletes=4,
                                     inserts=4))
        before = tier.backlog
        assert before > 0
        out = [before, tier.drain(timeout=0.0), tier.backlog]
        assert not out[1] and 0 < out[2] < before
        out += [tier.drain(timeout=None), tier.backlog]
        assert out[3] and out[4] == 0
        return out, tier.stats()

    both(scenario)


# ----------------------------------------------------- lifecycle: IMServer --

def test_imserver_start_idempotent_and_restartable():
    def scenario(P):
        stream = _stream(P)
        server = P.IMServer(stream, refresh_budget=64)
        server.start_refresh_worker()
        first = server._worker
        server.start_refresh_worker()           # idempotent: same worker
        states = [server._worker is first, server.async_refreshing]
        server.stop_refresh_worker()
        server.stop_refresh_worker()            # safe twice
        states.append(server.async_refreshing)
        server.start_refresh_worker()           # restartable
        states.append(server.async_refreshing)
        server.close()
        with server:
            server.start_refresh_worker()
        states.append(server.async_refreshing)
        server.close()
        engine = _engine(P, small_graph(P), small_cfg(P))
        with pytest.raises(ValueError, match="refresh_budget"):
            P.IMServer(engine).start_refresh_worker()
        assert states == [True, True, False, True, False]
        return states

    both(scenario)


def test_imserver_drain_timeout_inline_and_forever():
    def scenario(P):
        stream = _stream(P)
        server = P.IMServer(stream, refresh_budget=4)
        server.apply_delta(P.random_delta(
            stream.graph, np.random.default_rng(16), deletes=4, inserts=4))
        before = stream.stale
        out = [before, server.drain(timeout=0.0), stream.stale]
        assert before > 0 and not out[1] and out[2] < before
        out += [server.drain(timeout=None), stream.stale,
                server.drain(timeout=0.0)]
        assert out[3:] == [True, 0, True]
        return out

    both(scenario)


# ------------------------------------------------------------------ CLI --

#: the CLI's timings, and the fields the refresh worker's timing moves:
#: a streaming tenant's cache hits (whether a query found its store
#: repaired), refresh slices and the rows they were granted
_TIMING = [r"in [0-9.]+s \([0-9.]+ q/s\), p50=[0-9.]+ms p99=[0-9.]+ms",
           r"cache \{[^}]*\}", r"'steps': \d+, 'rows_granted': \d+"]
_STREAMING_TENANT = re.compile(r"(  tenant[13]: .* cache_hits=)\d+( .*"
                               r"refreshes=)\d+")


def _mask(line):
    for pat in _TIMING:
        line = re.sub(pat, "<masked>", line)
    return _STREAMING_TENANT.sub(r"\1<m>\2<m>", line)


def test_serve_tier_cli_matches_jax():
    argv = ["--workload", "tier", "--tenants", "5", "--tier-n", "128",
            "--max-theta", "256", "--duration", "0.25", "--qps", "96",
            "--refresh-budget", "128", "--replicas", "2"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jlaunch.main(argv)
    want = buf.getvalue().splitlines()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = tlaunch.main(argv + ["--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert out["drained"] and out["stats"]["pending"] == 0
    assert len(lines) == len(want) == 9
    assert [_mask(x) for x in lines] == [_mask(x) for x in want]
    assert lines[:2] == want[:2] and "drained=True" in lines[3]
    # --mesh (ROADMAP A8b): the reference's lines, the mesh named
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = tlaunch.main(argv + ["--mesh", "4", "--device", "cpu"])
    meshed = buf.getvalue().splitlines()
    assert out["drained"] and len(meshed) == 9
    assert meshed[0] == lines[0].replace("mesh=1", "mesh=4")
    assert [_mask(x) for x in meshed[1:]] == [_mask(x) for x in lines[1:]]


# ------------------------------------------------------ launch counts ----

def test_launch_counts_are_exact_under_threads():
    """N threads bump one counter M times each through ``launched``; the
    count comes to exactly N * M, and the designs' keys alike."""
    n_threads, m = 8, 2000
    _common.reset_launches()
    before = _common.launch_counts().get("probe_kernel", 0)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(m):
                _common.launched("probe_kernel", 0, design="d")
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    counts = _common.launch_counts()
    assert counts["probe_kernel"] - before == n_threads * m
    assert counts["probe_kernel:d"] == n_threads * m
    with pytest.raises(RuntimeError, match="error 7"):
        _common.launched("probe_kernel", 7)
    _common.reset_launches()
    assert _common.launch_counts()["probe_kernel"] == 0
