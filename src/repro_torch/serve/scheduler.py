"""SLO-aware refresh scheduling (``repro.serve.scheduler``): one global
repair budget a step, split across streaming tenants in proportion to
their weighted staleness backlog (``weight * engine.stale``).

Every backlogged tenant the budget can cover gets a floor of one row
(refresh is batch-granular, so one row repairs a tenant's smallest stale
batch and no backlog starves); the rest is split by largest remainder,
so the grants sum exactly to ``min(budget, total backlog)``, in a
deterministic order (largest share first, then name).  Tenants with no
backlog get nothing: repair follows where the deltas landed.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RefreshAllocation:
    """One tenant's slice of a scheduling step's global budget."""
    tenant: str
    budget: int          # rows of repair granted this step
    backlog: int         # staleness backlog observed at allocation time


class RefreshScheduler:
    """Splits a global per-step repair budget across tenant backlogs."""

    def __init__(self, budget: int):
        if budget < 1:
            raise ValueError(f"refresh budget must be >= 1, got {budget}")
        self.budget = int(budget)
        self.steps = 0
        self.rows_granted = 0

    def allocate(self, backlogs: dict[str, int],
                 weights: dict[str, float] = None) -> list[RefreshAllocation]:
        """The budget split for one step: ``backlogs`` maps tenant ->
        backlog (zero-backlog tenants get nothing), ``weights`` tenant ->
        priority multiplier (default 1.0).  Returns the allocations of
        backlogged tenants, largest share first."""
        weights = weights or {}
        live = {t: int(b) for t, b in backlogs.items() if b > 0}
        if not live:
            return []
        shares = {t: b * float(weights.get(t, 1.0)) for t, b in live.items()}
        total_share = sum(shares.values())
        budget = min(self.budget, sum(live.values()))
        # a floor of 1 for every backlogged tenant the budget covers (the
        # largest shares first when it cannot cover all), then a
        # largest-remainder proportional split of the rest
        order = sorted(live, key=lambda t: (-shares[t], t))
        covered = order[:budget]
        grant = {t: 1 for t in covered}
        rest = budget - len(covered)
        if rest > 0:
            quota = {t: rest * shares[t] / total_share for t in covered}
            for t in covered:
                extra = min(int(quota[t]), live[t] - grant[t])
                grant[t] += extra
                rest -= extra
            # remainders: largest fractional part first, capped at backlog
            frac = sorted(covered,
                          key=lambda t: (-(quota[t] - int(quota[t])), t))
            i = 0
            while rest > 0 and any(grant[t] < live[t] for t in covered):
                t = frac[i % len(frac)]
                if grant[t] < live[t]:
                    grant[t] += 1
                    rest -= 1
                i += 1
        self.steps += 1
        out = [RefreshAllocation(t, grant[t], live[t])
               for t in order if t in grant and grant[t] > 0]
        self.rows_granted += sum(a.budget for a in out)
        return out
