"""The IMServe tier on the card against the same tier on the CPU, bitwise
(the answers are coverage counts over the same rows: there is no
tolerance): a synchronous replay of the five-tenant mix (every
`ServedQuery` but its latency, the stats, the cache's epochs and the
selections equal); the refresh worker on the tier's own CUDA stream;
and epoch consistency with the worker racing queries and deltas, the
drained stores equal to a synchronous tier's.

Every test here needs a CUDA device and skips without one; the file
imports neither JAX nor the JAX package (from the repo root, with
``PYTHONPATH=src``: ``python -m pytest -q -m cuda
tests/test_torch_tier_cuda.py``).
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import IMMConfig  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    KIND_DELTA, IMServe, TenantSpec, make_trace, zipf_rates,
)
from repro_torch.stream import random_delta  # noqa: E402

pytestmark = pytest.mark.cuda

STORES = (dict(store="bitmap", adaptive_representation=False,
               selection_method="fused-rebuild"),
          dict(store="packed"), dict(store="auto"),
          dict(store="bitmap", adaptive_representation=False,
               selection_method="rebuild"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def mix_specs(n=512, theta=512):
    """The serving bench's five-tenant mix on the sparse sampler, its
    stores varied (as `chip_smoke.py`'s tier phases run it)."""
    specs = []
    for i, store in enumerate(STORES):
        cfg = IMMConfig(k=10, batch=max(theta // 4, 64), max_theta=1 << 20,
                        seed=i, sampler="IC/sparse", **store)
        specs.append(TenantSpec(
            f"campaign-{i}", graph=generators.rmat_graph(
                n, 8 * n, seed=10 + i, weighted_ic="wc"),
            cfg=cfg, theta=theta, streaming=i % 2 == 1,
            slo="relaxed" if i == 2 else "strict",
            replicas=2 if i == 2 else 0, weight=2.0 if i == 0 else 1.0,
            max_pending=4096))
    specs.append(TenantSpec("campaign-4", share_engine_with="campaign-0",
                            weight=0.5, max_pending=4096))
    return specs


def build(device, refresh_budget=64):
    tier = IMServe(device=device, quantum=8, refresh_budget=refresh_budget)
    for spec in mix_specs():
        tier.register(spec)
    graphs = {t.name: t.graph for t in tier.tenants.values()}
    streaming = {t.name: t.streaming and t.owns_engine
                 for t in tier.tenants.values()}
    events = make_trace(
        graphs, duration=1.0, qps=zipf_rates(
            sorted(graphs), 96.0 * len(graphs), 1.0,
            np.random.default_rng(0)),
        streaming=streaming, delta_period=0.25, delta_ops=4, seed=1)
    return tier, events


def replay(tier, events, *, sync):
    """The trace in arrival order; ``sync``: a refresh step after every
    pump (no worker).  Returns the tickets."""
    tickets = []
    for e in events:
        if e.kind == KIND_DELTA:
            tier.apply_delta(e.tenant, e.delta)
        else:
            tickets.append(tier.submit(e.tenant, e.seeds))
        if tier.pending >= 16:
            tier.pump()
            if sync:
                tier.refresh_step()
    while tier.pending:
        tier.pump()
        if sync:
            tier.refresh_step()
    assert tier.drain(timeout=120.0)
    return tickets


def record(tier, tickets):
    recs = [tier.result(t) for t in tickets]
    return dict(
        recs=[(r.ticket, r.tenant, r.value, r.epoch, r.cached, r.replica)
              for r in recs],
        stats=tier.stats(),
        epochs={n: sorted(tier.cache.epochs(n)) for n in tier.tenants},
        sels={n: [int(s) for s in tier.select(n, 10).seeds]
              for n in tier.tenants})


def test_tier_sync_replay_cuda_equals_cpu(cuda):
    out = {}
    for dev in ("cuda", "cpu"):
        ops.reset_launches()
        tier, events = build(dev)
        out[dev] = record(tier, replay(tier, events, sync=True))
        out[dev]["launches"] = ops.launch_counts()
    launched = out["cuda"].pop("launches")
    assert not any(out["cpu"].pop("launches").values())
    assert out["cuda"] == out["cpu"]
    flags = {(r[4], r[5]) for r in out["cuda"]["recs"]}
    assert (True, False) in flags and (False, True) in flags
    for name in ("arena_commit", "arena_commit_packed", "coverage_matvec",
                 "fused_select", "packed_count", "ic_sparse_hits"):
        assert launched.get(name, 0) > 0, name


def test_refresh_worker_runs_on_the_tiers_stream(cuda):
    """A tier built under a side stream: every refresh slice the worker
    runs is on that stream and device, not the new thread's default."""
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        tier = IMServe(device="cuda", quantum=4, refresh_budget=16)
        tier.register(TenantSpec(
            "s", graph=generators.rmat_graph(256, 2048, seed=3),
            cfg=IMMConfig(k=4, batch=64, max_theta=4096, seed=0,
                          sampler="IC/sparse"),
            theta=512, streaming=True))
    engine = tier.tenants["s"].engine
    seen = []
    refresh = engine.refresh

    def spy(budget=None):
        seen.append((threading.current_thread().name,
                     torch.cuda.current_stream().cuda_stream))
        return refresh(budget)

    engine.refresh = spy
    tier.apply_delta("s", random_delta(engine.graph,
                                       np.random.default_rng(4),
                                       deletes=6, inserts=6))
    with tier:
        tier.start_refresh_worker()
        assert tier.drain(timeout=60.0)
    assert not tier.refreshing
    assert seen and {s for _, s in seen} == {side.cuda_stream}
    assert {t for t, _ in seen} == {"imserve-refresh"}


def test_racing_worker_stays_epoch_consistent_on_the_card(cuda):
    """Queries race the worker and a delta thread on the card: each DRR
    batch is one store state (one value, one epoch); once drained, the
    stream equals one refreshed synchronously through the same deltas,
    and a repeat is a cache hit of the same value."""
    def tier_on(dev):
        tier = IMServe(device=dev, quantum=4, refresh_budget=32)
        tier.register(TenantSpec(
            "s", graph=generators.rmat_graph(512, 4096, seed=2),
            cfg=IMMConfig(k=4, batch=128, max_theta=4096, seed=0,
                          sampler="IC/sparse"),
            theta=1024, streaming=True))
        return tier

    tier = tier_on("cuda")
    probe = np.array([8, 33, 60], np.int32)
    deltas, batches, errors = [], [], []
    stop = threading.Event()

    def mutate():
        rng = np.random.default_rng(13)
        try:
            while not stop.is_set() and len(deltas) < 12:
                d = random_delta(tier.tenants["s"].graph, rng, inserts=2,
                                 deletes=2)
                tier.apply_delta("s", d)
                deltas.append(d)
                time.sleep(0.002)
        except Exception as e:                # pragma: no cover
            errors.append(e)

    with tier:
        tier.start_refresh_worker()
        mut = threading.Thread(target=mutate)
        mut.start()
        try:
            for _ in range(12):
                batches.append([tier.submit("s", probe) for _ in range(3)])
                tier.flush()
        finally:
            stop.set()
            mut.join(timeout=60)
        assert not mut.is_alive()
        assert tier.drain(timeout=60.0)
    assert not errors and deltas
    for batch in batches:
        recs = [tier.result(t) for t in batch]
        assert len({r.value for r in recs}) == 1, "torn read in one batch"
        assert len({r.epoch for r in recs}) == 1
    ref = tier_on("cpu")
    for d in deltas:
        ref.apply_delta("s", d)
    assert ref.drain(timeout=None)
    a, b = tier.tenants["s"].engine, ref.tenants["s"].engine
    assert torch.equal(a.store.counter.cpu(), b.store.counter)
    assert list(a.select(4).seeds) == list(b.select(4).seeds)
    t1 = tier.submit("s", probe)
    tier.flush()
    t2 = tier.submit("s", probe)
    tier.flush()
    assert tier.result(t2).cached
    assert tier.result(t2).value == tier.result(t1).value == float(
        b.influences([probe])[0])
