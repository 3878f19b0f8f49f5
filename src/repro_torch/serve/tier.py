"""IMServe — the multi-tenant influence-serving tier
(``repro.serve.tier``).

The layer above the engines: `launch/serve.py`'s `IMServer` is one
engine, one lock, one refresh thread; this tier multiplexes many
campaigns over engines:

  * **tenant registry** (`repro_torch.serve.tenant`): each campaign gets
    its own `StreamEngine`/`InfluenceEngine`, or a slot on another
    tenant's engine;
  * **admission control + fairness** (`repro_torch.serve.admission`):
    bounded per-tenant queues drained in deficit-round-robin order;
  * **epoch-keyed result cache** (`repro_torch.serve.cache`): sigma(S)
    keyed ``(tenant, epoch, frozenset(S))``, invalidated exactly when
    the tenant's served epoch moves, so a hit is bitwise a recompute;
  * **replica read scaling** (`repro_torch.serve.replica`): relaxed-SLO
    queries read epoch-consistent replicas, strict ones the primary;
  * **SLO-aware refresh** (`repro_torch.serve.scheduler`): one repair
    budget a step, split by weighted staleness backlog, spent
    cooperatively (`refresh_step`) or on a background worker.

Every engine access (a tenant's query batch, a delta, a refresh slice,
a replica snapshot) holds that tenant's lock, so each batch is answered
against one store state and tagged with its epoch.  The tier's own lock
covers only host-side queue and result bookkeeping.  Tenant engines run
on ``device`` (``cuda`` unless told otherwise), and the refresh worker
runs on the device and CUDA stream the tier was built on: queries and
repairs share arena buffers, and the tenant lock orders them only on
one stream.  With ``mesh_kwargs`` every engine the tier builds runs on
the mesh (`repro_torch.configs.imm_snap.mesh_engine_kwargs`), and the
meshed tenants share one dispatch lock (see `IMServe`).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.serve.admission import (
    AdmissionError, DeficitRoundRobin, QueryTicket,
)
from repro_torch.serve.cache import ResultCache
from repro_torch.serve.replica import ReplicaGroup
from repro_torch.serve.scheduler import RefreshAllocation, RefreshScheduler
from repro_torch.serve.tenant import Tenant, TenantSpec


@dataclasses.dataclass(frozen=True)
class ServedQuery:
    """One answered query: the value, the epoch it was computed at, how
    it was served (cache / replica / primary) and its latency."""
    ticket: int
    tenant: str
    value: float
    epoch: int
    cached: bool
    replica: bool
    latency_s: float


class IMServe:
    """Multi-tenant influence-serving tier over pooled engines.

    ``quantum`` is the DRR quantum (queries a weight-1.0 tenant serves a
    round); ``cache_entries`` the result cache's LRU capacity;
    ``refresh_budget`` the rows of repair a `refresh_step`, split by the
    scheduler (None: no tier refresh); ``mesh_kwargs`` the engine mesh
    keywords every tenant engine this tier builds takes; ``device`` where
    those engines run (``cuda`` unless told otherwise; a meshed engine's
    tiles are on its mesh's devices).

    Meshed tenants share one dispatch ``RLock`` (the reference's
    ``_mesh_lock``), held in place of each tenant's own lock.  The
    reference needs it because two threads' collectives on one set of
    devices can interleave their rendezvous and deadlock.  The port has
    no rendezvous, but the lock stays: every meshed engine launches on
    every tile device's current stream and stages its collectives there
    (peer copies, the BFS's side-stream frontier gather), so a worker's
    repair and another tenant's query would interleave their work on
    the same device streams; one lock keeps each meshed call whole on
    them and keeps the reference's schedule (one meshed dispatch at a
    time).  Off a mesh each tenant keeps its own lock.
    """

    def __init__(self, *, quantum: int = 8, cache_entries: int = 65536,
                 refresh_budget: Optional[int] = None,
                 mesh_kwargs: dict = None, device=None):
        self.mesh_kwargs = dict(mesh_kwargs or {})
        self.device = resolve_device(device)
        self.tenants: dict[str, Tenant] = {}
        self.replica_groups: dict[str, ReplicaGroup] = {}
        self.cache = ResultCache(cache_entries)
        self.queue = DeficitRoundRobin(quantum)
        self.scheduler = (RefreshScheduler(refresh_budget)
                          if refresh_budget is not None else None)
        self.queries_served = 0
        self._results: dict[int, ServedQuery] = {}
        self._next_ticket = 0
        self._mesh_lock = threading.RLock()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)

    # ------------------------------------------------------------ tenants

    def register(self, spec: TenantSpec) -> Tenant:
        """Register a tenant: build (or share) its engine, sample its
        store to ``spec.theta``, arm its admission queue and fan out its
        first replica set."""
        if spec.name in self.tenants:
            raise ValueError(f"tenant {spec.name!r} already registered")
        if spec.share_engine_with is not None:
            host = self.tenants.get(spec.share_engine_with)
            if host is None:
                raise ValueError(
                    f"tenant {spec.name!r}: share_engine_with names "
                    f"unknown tenant {spec.share_engine_with!r}")
            tenant = Tenant(spec, engine=host.engine, lock=host.lock)
        else:
            tenant = Tenant(spec, mesh_kwargs=self.mesh_kwargs,
                            device=self.device)
            if self.mesh_kwargs.get("mesh") is not None:
                tenant.lock = self._mesh_lock   # see the class docstring
        self.tenants[spec.name] = tenant
        self.queue.register(spec.name, weight=spec.weight,
                            max_pending=spec.max_pending)
        if spec.replicas > 0:
            group = ReplicaGroup(tenant.engine, spec.replicas)
            with tenant.lock:
                group.sync(tenant.epoch)
            self.replica_groups[spec.name] = group
        return tenant

    def _tenant(self, name: str) -> Tenant:
        t = self.tenants.get(name)
        if t is None:
            raise KeyError(f"unknown tenant {name!r}")
        return t

    # ------------------------------------------------------------ queries

    def try_submit(self, tenant: str, seed_set) -> Optional[int]:
        """Admission-controlled submit: a ticket id, or None when the
        tenant's queue is at its cap (the rejection is counted)."""
        t = self._tenant(tenant)
        seeds = np.asarray(seed_set, np.int32).reshape(-1)
        with self._lock:
            ticket = QueryTicket(self._next_ticket, tenant, seeds,
                                 t_submit=time.monotonic())
            self._next_ticket += 1
            t.submitted += 1
            if not self.queue.try_submit(ticket):
                t.rejected += 1
                obs.counter("serve.rejected", tenant=tenant).add(1)
                return None
            obs.gauge("serve.queue_depth", tenant=tenant).set(
                self.queue.pending(tenant))
        return ticket.id

    def submit(self, tenant: str, seed_set) -> int:
        """`try_submit` that raises `AdmissionError` on a rejection."""
        tid = self.try_submit(tenant, seed_set)
        if tid is None:
            t = self._tenant(tenant)
            raise AdmissionError(
                f"tenant {tenant!r}: queue full "
                f"({self.queue.pending(tenant)}/{t.spec.max_pending} "
                f"pending)")
        return tid

    @property
    def pending(self) -> int:
        with self._lock:
            return self.queue.pending()

    def _serve_batch(self, tenant: Tenant,
                     tickets: list[QueryTicket]) -> dict[int, float]:
        """Answer one tenant's DRR share against one store state."""
        name = tenant.name
        group = self.replica_groups.get(name)
        use_replica = (tenant.spec.slo == "relaxed" and group is not None
                       and group.servable)
        with obs.span("serve.batch", tier="serve", tenant=name,
                      queries=len(tickets)), tenant.lock:
            epoch = group.synced_epoch if use_replica else tenant.epoch
            if epoch != tenant.served_epoch:
                # older entries become unreachable now: drop them once
                self.cache.advance(name, epoch)
                tenant.served_epoch = epoch
            # mid-repair (stale > 0) the store changes within the epoch:
            # those answers bypass the cache; a replica's store changes
            # only at a sync, which moves its epoch
            consistent = (use_replica
                          or getattr(tenant.engine, "stale", 0) == 0)
            keys = [self.cache.key(name, epoch, t.seeds) for t in tickets]
            vals: dict[int, tuple[float, bool]] = {}
            misses = []
            with obs.span("cache", tier="serve", tenant=name):
                for tk, key in zip(tickets, keys):
                    hit = self.cache.get(key) if consistent else None
                    if hit is not None:
                        vals[tk.id] = (hit, True)
                    else:
                        misses.append((tk, key))
            if misses:
                backend = group if use_replica else tenant.engine
                fresh = backend.influences([tk.seeds for tk, _ in misses])
                for (tk, key), v in zip(misses, np.asarray(fresh)):
                    if consistent:
                        self.cache.put(key, float(v))
                    vals[tk.id] = (float(v), False)
        now = time.monotonic()
        out = {}
        with self._lock:
            for tk in tickets:
                v, cached = vals[tk.id]
                self._results[tk.id] = ServedQuery(
                    tk.id, name, v, epoch, cached, use_replica,
                    now - tk.t_submit)
                out[tk.id] = v
            tenant.served += len(tickets)
            tenant.cache_hits += sum(1 for v in vals.values() if v[1])
            if use_replica:
                tenant.replica_reads += len(tickets)
            self.queries_served += len(tickets)
        if obs.enabled():
            hits = sum(1 for v in vals.values() if v[1])
            if consistent:
                obs.counter("serve.cache_hits", tenant=name).add(hits)
                obs.counter("serve.cache_misses",
                            tenant=name).add(len(misses))
            else:
                obs.counter("serve.cache_bypass",
                            tenant=name).add(len(tickets))
            lat = obs.histogram("serve.latency_ms", tenant=name)
            slo_ms = tenant.spec.latency_slo_ms
            violations = 0
            for tk in tickets:
                ms = (now - tk.t_submit) * 1e3
                lat.observe(ms)
                if slo_ms is not None and ms > slo_ms:
                    violations += 1
            if violations:
                obs.counter("serve.slo_violations",
                            tenant=name).add(violations)
        return out

    def pump(self) -> dict[int, float]:
        """One DRR round: every backlogged tenant serves its weighted
        share, each share one batched ``influences`` call against one
        epoch.  Returns ``{ticket: value}`` for the round."""
        with obs.span("admission", tier="serve"), self._lock:
            round_ = self.queue.take_round()
        if obs.enabled():
            obs.counter("serve.drr_rounds").add(1)
            for name, tickets in round_:
                obs.gauge("serve.queue_depth", tenant=name).set(
                    self.queue.pending(name))
        results = {}
        for name, tickets in round_:
            results.update(self._serve_batch(self._tenant(name), tickets))
        return results

    def flush(self) -> dict[int, float]:
        """Pump until every queue is empty (round by round, still fair)."""
        results = {}
        while self.pending:
            results.update(self.pump())
        return results

    def result(self, ticket: int) -> Optional[ServedQuery]:
        """The `ServedQuery` of an answered ticket (None while pending
        or unknown)."""
        with self._lock:
            return self._results.get(ticket)

    def select(self, tenant: str, k: int):
        """Top-k for one tenant (strict: the primary's memoized
        selection; relaxed: a replica's)."""
        t = self._tenant(tenant)
        group = self.replica_groups.get(tenant)
        if t.spec.slo == "relaxed" and group is not None and group.servable:
            return group.select(k)
        with t.lock:
            return t.engine.select(k)

    # ------------------------------------------------------------- deltas

    def apply_delta(self, tenant: str, delta) -> int:
        """Forward a `GraphDelta` to a streaming tenant: its epoch
        advances and the touched rows go stale.  Returns the newly stale
        rows."""
        t = self._tenant(tenant)
        if not t.streaming:
            raise ValueError(
                f"tenant {tenant!r} is static (streaming=False); deltas "
                f"need a StreamEngine tenant")
        with t.lock:
            stale = t.engine.apply_delta(delta)
        t.deltas_applied += 1
        return stale

    # ------------------------------------------------------------ refresh

    def refresh_step(self) -> list[RefreshAllocation]:
        """One scheduling step: split the budget across streaming
        tenants by weighted backlog, run each slice under its tenant
        lock, then re-sync the replica groups whose primary reached a
        consistent newer epoch.  Returns the allocations."""
        if self.scheduler is None:
            raise ValueError("tier was built without a refresh_budget")
        backlogs, weights = {}, {}
        for name, t in self.tenants.items():
            if t.streaming and t.owns_engine:
                backlogs[name] = t.backlog
                weights[name] = t.spec.weight
        allocations = self.scheduler.allocate(backlogs, weights)
        for a in allocations:
            t = self.tenants[a.tenant]
            with t.lock:
                t.engine.refresh(a.budget)
        self.sync_replicas()
        return allocations

    def sync_replicas(self) -> int:
        """Fan out a fresh snapshot to every replica group whose primary
        moved past the group's epoch and is consistent (a mid-repair
        store is one no epoch ever served).  Returns groups synced."""
        synced = 0
        for name, group in self.replica_groups.items():
            t = self.tenants[name]
            with t.lock:
                if (t.epoch != group.synced_epoch
                        and getattr(t.engine, "stale", 0) == 0):
                    group.sync(t.epoch)
                    synced += 1
        return synced

    @property
    def backlog(self) -> int:
        """Total staleness backlog across streaming tenants."""
        return sum(t.backlog for t in self.tenants.values()
                   if t.owns_engine)

    # ----------------------------------------------- background refresh

    def start_refresh_worker(self) -> None:
        """Run `refresh_step` continuously on a daemon thread
        (idempotent; needs a ``refresh_budget``)."""
        if self.scheduler is None:
            raise ValueError("refresh worker needs a refresh_budget")
        if self._worker is not None and self._worker.is_alive():
            return
        self._stop.clear()
        self._worker = threading.Thread(
            target=self._refresh_loop, name="imserve-refresh", daemon=True)
        self._worker.start()

    def stop_refresh_worker(self) -> None:
        """Stop and join the worker (idempotent, safe after close)."""
        self._stop.set()
        worker, self._worker = self._worker, None
        if worker is not None and worker is not threading.current_thread():
            worker.join()

    close = stop_refresh_worker

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop_refresh_worker()

    @property
    def refreshing(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    def _refresh_loop(self):
        # a new thread starts on the default device and stream; the
        # worker runs on the tier's (a no-op context on the CPU)
        with torch.cuda.stream(self._stream):
            while not self._stop.is_set():
                if self.refresh_step():
                    # Python locks are not fair: yield between slices so
                    # a query thread blocked on a tenant lock gets it
                    time.sleep(1e-4)
                else:
                    self._stop.wait(0.002)

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Block until every streaming tenant's backlog is repaired
        (True) or ``timeout`` seconds pass (False; None waits forever).
        Without a running worker the steps run inline, and the deadline
        is checked after each, so a finite timeout still progresses."""
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        while self.backlog > 0:
            if self.refreshing:
                time.sleep(0.002)
            else:
                self.refresh_step()
            if (self.backlog > 0 and deadline is not None
                    and time.monotonic() > deadline):
                return False
        return True

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Monitoring snapshot: per-tenant counters, cache, scheduler
        and replica-group stats."""
        out = {
            "tenants": {n: t.stats() for n, t in self.tenants.items()},
            "cache": self.cache.stats(),
            "queries_served": self.queries_served,
            "pending": self.pending,
        }
        if self.scheduler is not None:
            out["refresh"] = {"budget": self.scheduler.budget,
                              "steps": self.scheduler.steps,
                              "rows_granted": self.scheduler.rows_granted}
        if self.replica_groups:
            out["replicas"] = {n: g.stats()
                               for n, g in self.replica_groups.items()}
        return out

    def metrics(self) -> dict:
        """The obs registry's snapshot (counters, gauges, histograms;
        empty unless `repro_torch.obs` is enabled)."""
        return obs.snapshot()
