"""Tenant registry (``repro.serve.tenant``): one campaign, one engine or
one slot on another tenant's engine.

`TenantSpec` is the declaration (graph, config, resident theta, SLO
class, fairness weight, admission depth, replicas); `Tenant` is the
runtime object the tier schedules.  It owns the engine (a port
`StreamEngine` for an evolving graph, an `InfluenceEngine` for a static
one, built on the device and, with ``mesh_kwargs``, the mesh the tier
passes down), the lock that every
query batch, delta, refresh slice and replica snapshot holds, and the
serving counters.  ``share_engine_with`` points a tenant at a registered
tenant's engine and lock (campaigns planning on one network share one
sampled store); admission, fairness and cache keys stay per tenant.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from repro_torch.core.engine import IMMConfig, InfluenceEngine
from repro_torch.core.store import StorePressurePolicy
from repro_torch.graphs.csr import Graph
from repro_torch.stream.engine import StreamEngine

#: SLO classes the tier routes on: "strict" answers always come from the
#: tenant's primary engine at its current epoch; "relaxed" answers may
#: come from a read replica at its last epoch-consistent sync
SLO_CLASSES = ("strict", "relaxed")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Declarative tenant description the tier registers.

    ``name`` keys the cache and the stats; ``graph`` is the campaign's
    network (ignored with ``share_engine_with``); ``cfg`` the engine
    config (None: `IMMConfig()`); ``theta`` the resident rows sampled at
    registration; ``streaming`` serves through a `StreamEngine`;
    ``slo`` is one of `SLO_CLASSES`; ``weight`` the DRR weight and the
    refresh priority multiplier; ``max_pending`` the admission depth;
    ``replicas`` the read replicas relaxed queries route to; ``policy``
    an optional `StorePressurePolicy` (streaming only);
    ``share_engine_with`` a registered tenant whose engine and lock this
    one shares; ``latency_slo_ms`` an optional latency objective counted
    in ``serve.slo_violations`` (routing never keys on it).
    """
    name: str
    graph: Optional[Graph] = None
    cfg: Optional[IMMConfig] = None
    theta: int = 1024
    streaming: bool = False
    slo: str = "strict"
    weight: float = 1.0
    max_pending: int = 1024
    replicas: int = 0
    policy: Optional[StorePressurePolicy] = None
    share_engine_with: Optional[str] = None
    latency_slo_ms: Optional[float] = None

    def __post_init__(self):
        if self.slo not in SLO_CLASSES:
            raise ValueError(
                f"tenant {self.name!r}: slo must be one of {SLO_CLASSES}, "
                f"got {self.slo!r}")
        if self.latency_slo_ms is not None and self.latency_slo_ms <= 0:
            raise ValueError(
                f"tenant {self.name!r}: latency_slo_ms must be > 0, got "
                f"{self.latency_slo_ms}")
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, got "
                f"{self.weight}")
        if self.max_pending < 1:
            raise ValueError(
                f"tenant {self.name!r}: max_pending must be >= 1, got "
                f"{self.max_pending}")
        if self.graph is None and self.share_engine_with is None:
            raise ValueError(
                f"tenant {self.name!r} needs a graph (or an engine slot "
                f"via share_engine_with)")


class Tenant:
    """Runtime tenant: engine + lock + serving counters.

    ``lock`` serializes every engine access, so a batch answered under
    it reads exactly one store state (stores write their arenas in
    place on repair, so an unlocked reader could see a torn one).  With
    ``engine`` given (a shared slot) the lock is the host tenant's.
    Otherwise the engine is built on ``device`` (``cuda`` unless told
    otherwise) and sampled to ``spec.theta`` rows.
    """

    def __init__(self, spec: TenantSpec, *, engine=None, lock=None,
                 mesh_kwargs: dict = None, device=None):
        self.spec = spec
        self.name = spec.name
        if engine is not None:
            self.engine = engine
            self.lock = lock if lock is not None else threading.RLock()
            self.owns_engine = False
        else:
            kw = dict(mesh_kwargs or {})
            cfg = spec.cfg if spec.cfg is not None else IMMConfig()
            if spec.streaming:
                self.engine = StreamEngine(spec.graph, cfg,
                                           policy=spec.policy,
                                           device=device, **kw)
            else:
                if spec.policy is not None:
                    raise ValueError(
                        f"tenant {spec.name!r}: StorePressurePolicy needs "
                        f"streaming=True (static stores never evict)")
                self.engine = InfluenceEngine(spec.graph, cfg,
                                              device=device, **kw)
            self.engine.extend(spec.theta)
            self.lock = threading.RLock()
            self.owns_engine = True
        # serving counters (the tier keeps them; reads are monitoring)
        self.submitted = 0
        self.rejected = 0
        self.served = 0
        self.cache_hits = 0
        self.replica_reads = 0
        self.deltas_applied = 0
        self.served_epoch = self.epoch

    # ------------------------------------------------------------- state

    @property
    def streaming(self) -> bool:
        return hasattr(self.engine, "apply_delta")

    @property
    def epoch(self) -> int:
        """The engine's current epoch (0 forever for a static tenant)."""
        return getattr(self.engine, "epoch", 0)

    @property
    def backlog(self) -> int:
        """Staleness backlog the refresh scheduler allocates against."""
        return getattr(self.engine, "stale", 0)

    @property
    def graph(self) -> Graph:
        return self.engine.graph

    def stats(self) -> dict:
        return {
            "slo": self.spec.slo,
            "weight": self.spec.weight,
            "submitted": self.submitted,
            "rejected": self.rejected,
            "served": self.served,
            "cache_hits": self.cache_hits,
            "replica_reads": self.replica_reads,
            "epoch": self.epoch,
            "served_epoch": self.served_epoch,
            "backlog": self.backlog,
            "deltas_applied": self.deltas_applied,
            "refreshes": getattr(self.engine, "refreshes", 0),
            "rows_repaired": getattr(self.engine, "rows_repaired", 0),
            "shared_engine": not self.owns_engine,
        }
