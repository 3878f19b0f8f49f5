"""Trace-driven load (``repro.serve.trace``): per-tenant Poisson query
streams interleaved with graph deltas, from one rng seed.

  * each tenant's queries arrive as a Poisson process at its own rate
    (`zipf_rates` draws skewed rates: a heavy tenant and a long tail);
  * each query is a random seed set, except a ``hot_fraction`` drawn
    from a small per-tenant pool of recurring sets (the cache's hits);
  * streaming tenants get a delta every ``delta_period``, drawn against
    the tenant's evolving graph (`repro_torch.stream.random_delta`,
    applied on the host as the trace is built).

With the same seed the events are the reference's, one for one: the same
draws from one ``np.random.Generator`` in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.stream.delta import GraphDelta, random_delta

KIND_QUERY = "query"
KIND_DELTA = "delta"


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One timestamped workload event."""
    t: float                      # arrival time, seconds from trace start
    tenant: str
    kind: str                     # KIND_QUERY | KIND_DELTA
    seeds: Optional[np.ndarray] = None      # KIND_QUERY
    delta: Optional[GraphDelta] = None      # KIND_DELTA


def zipf_rates(names, total_qps: float, skew: float, rng) -> dict:
    """Per-tenant rates summing to ``total_qps`` with a Zipf profile of
    exponent ``skew`` over a random tenant order (0 is uniform)."""
    order = list(names)
    rng.shuffle(order)
    raw = np.array([1.0 / (i + 1) ** skew for i in range(len(order))])
    raw = raw / raw.sum() * total_qps
    return {t: float(r) for t, r in zip(order, raw)}


def _poisson_times(rate: float, duration: float, rng) -> np.ndarray:
    if rate <= 0:
        return np.zeros((0,))
    gaps = rng.exponential(1.0 / rate, size=max(int(rate * duration * 2), 16))
    times = np.cumsum(gaps)
    while times.size and times[-1] < duration:
        more = np.cumsum(rng.exponential(1.0 / rate, size=16)) + times[-1]
        times = np.concatenate([times, more])
    return times[times < duration]


def make_trace(graphs: dict, *, duration: float = 1.0,
               qps: dict | float = 100.0,
               streaming: dict = None,
               delta_period: float = 0.25, delta_ops: int = 4,
               max_dst_indeg: int = 8,
               set_sizes: tuple[int, int] = (1, 8),
               hot_fraction: float = 0.5, hot_pool: int = 8,
               seed: int = 0) -> list[TraceEvent]:
    """A merged, time-sorted multi-tenant event trace.

    ``graphs`` maps tenant -> `Graph` its queries draw vertices from
    (streaming tenants: the graph its deltas evolve); ``duration`` is in
    virtual seconds; ``qps`` one rate for all or tenant -> rate;
    ``streaming`` tenant -> bool adds a delta stream; ``delta_ops``
    inserts = deletes = reweights a delta; ``set_sizes`` the inclusive
    range of a query's seed-set size; ``hot_fraction`` the chance a
    query re-asks one of ``hot_pool`` recurring sets; ``seed`` fixes
    the whole trace.
    """
    rng = np.random.default_rng(seed)
    streaming = streaming or {}
    lo, hi = set_sizes
    events: list[TraceEvent] = []
    for name in sorted(graphs):
        g = graphs[name]
        rate = qps[name] if isinstance(qps, dict) else float(qps)
        hot = [rng.choice(g.n, size=int(rng.integers(lo, hi + 1)),
                          replace=False).astype(np.int32)
               for _ in range(hot_pool)]
        for t in _poisson_times(rate, duration, rng):
            if rng.random() < hot_fraction:
                seeds = hot[int(rng.integers(len(hot)))]
            else:
                seeds = rng.choice(
                    g.n, size=int(rng.integers(lo, hi + 1)),
                    replace=False).astype(np.int32)
            events.append(TraceEvent(float(t), name, KIND_QUERY,
                                     seeds=seeds))
        if streaming.get(name):
            gg, tick = g, delta_period
            while tick < duration:
                d = random_delta(gg, rng, inserts=delta_ops,
                                 deletes=delta_ops, reweights=delta_ops,
                                 max_dst_indeg=max_dst_indeg)
                events.append(TraceEvent(float(tick), name, KIND_DELTA,
                                         delta=d))
                gg = d.apply(gg)
                tick += delta_period
    # a stable tiebreak (tenant, kind) keeps replay deterministic when two
    # events share a timestamp
    events.sort(key=lambda e: (e.t, e.tenant, e.kind))
    return events


def replay(tier, events: list[TraceEvent], *,
           pump_every: int = 16) -> tuple[dict, int]:
    """Replay a trace through an `IMServe` tier in event order: queries
    through admission (`try_submit`; rejections are counted, not
    retried), deltas through `apply_delta`; a pump whenever
    ``pump_every`` queries are pending and a flush at the end.  Returns
    ``({ticket: value}, rejected_count)``; each query's record is
    ``tier.result(ticket)``."""
    answered: dict[int, float] = {}
    rejected = 0
    for e in events:
        if e.kind == KIND_DELTA:
            tier.apply_delta(e.tenant, e.delta)
        else:
            if tier.try_submit(e.tenant, e.seeds) is None:
                rejected += 1
        if tier.pending >= pump_every:
            answered.update(tier.pump())
    answered.update(tier.flush())
    return answered, rejected


def trace_summary(events: list[TraceEvent]) -> dict:
    """Per-tenant event counts (queries, deltas) for logging."""
    out: dict[str, dict] = {}
    for e in events:
        d = out.setdefault(e.tenant, {"queries": 0, "deltas": 0})
        d["queries" if e.kind == KIND_QUERY else "deltas"] += 1
    return out
