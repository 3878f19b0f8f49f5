"""Admission control and deficit-round-robin fairness for the query queue
(``repro.serve.admission``).

A heavy tenant must not starve the others: admission control caps each
tenant's pending depth (a submit past the cap is rejected at the door,
not queued), and deficit round robin gives every backlogged tenant a
weighted share of each scheduling round.

DRR here is the classic scheme with unit query cost: each round, every
tenant with pending queries earns ``quantum * weight`` credit, serves
queries while credit lasts and keeps the remainder for the next round;
a tenant whose queue empties forfeits its credit (no hoarding).  Rounds
go in registration order.  All of it is host-side and deterministic, as
in the reference.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


class AdmissionError(RuntimeError):
    """A submit was rejected: the tenant's pending queue is full."""


@dataclasses.dataclass
class QueryTicket:
    """One admitted sigma(S) query waiting for service."""
    id: int
    tenant: str
    seeds: np.ndarray
    t_submit: float = 0.0


class _TenantQueue:
    __slots__ = ("queue", "weight", "max_pending", "deficit")

    def __init__(self, weight: float, max_pending: int):
        self.queue: deque[QueryTicket] = deque()
        self.weight = float(weight)
        self.max_pending = int(max_pending)
        self.deficit = 0.0


class DeficitRoundRobin:
    """Admission-controlled per-tenant queues under DRR service."""

    def __init__(self, quantum: int = 8):
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        self.quantum = int(quantum)
        self._tenants: dict[str, _TenantQueue] = {}

    def register(self, tenant: str, *, weight: float = 1.0,
                 max_pending: int = 1024) -> None:
        if tenant in self._tenants:
            raise ValueError(f"tenant {tenant!r} already registered")
        self._tenants[tenant] = _TenantQueue(weight, max_pending)

    # ---------------------------------------------------------- admission

    def try_submit(self, ticket: QueryTicket) -> bool:
        """Admit ``ticket`` unless the tenant's queue is at its cap;
        False (rejected) instead of raising."""
        tq = self._tenants[ticket.tenant]
        if len(tq.queue) >= tq.max_pending:
            return False
        tq.queue.append(ticket)
        return True

    def submit(self, ticket: QueryTicket) -> None:
        if not self.try_submit(ticket):
            tq = self._tenants[ticket.tenant]
            raise AdmissionError(
                f"tenant {ticket.tenant!r}: queue full "
                f"({len(tq.queue)}/{tq.max_pending} pending)")

    # ------------------------------------------------------------ service

    def pending(self, tenant: str = None) -> int:
        if tenant is not None:
            return len(self._tenants[tenant].queue)
        return sum(len(t.queue) for t in self._tenants.values())

    def take_round(self) -> list[tuple[str, list[QueryTicket]]]:
        """One DRR round: ``[(tenant, tickets), ...]`` in registration
        order, each tenant's list bounded by its accumulated deficit.
        Empty when nothing is pending."""
        out = []
        for name, tq in self._tenants.items():
            if not tq.queue:
                tq.deficit = 0.0          # no hoarding across idle rounds
                continue
            tq.deficit += self.quantum * tq.weight
            batch = []
            while tq.queue and tq.deficit >= 1.0:
                batch.append(tq.queue.popleft())
                tq.deficit -= 1.0
            if not tq.queue:
                tq.deficit = 0.0
            if batch:
                out.append((name, batch))
        return out
