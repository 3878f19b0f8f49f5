"""IMServe — multi-tenant influence serving (``repro.serve``), the tier
above the engines:

  * `IMServe` / `ServedQuery` — the tier: tenant registry, admission and
    DRR fairness, the epoch-keyed result cache, replica routing and
    SLO-aware refresh (`repro_torch.serve.tier`);
  * `TenantSpec` / `Tenant` (`repro_torch.serve.tenant`);
  * `ResultCache` (`repro_torch.serve.cache`);
  * `DeficitRoundRobin` / `QueryTicket` / `AdmissionError`
    (`repro_torch.serve.admission`);
  * `RefreshScheduler` / `RefreshAllocation` (`repro_torch.serve.scheduler`);
  * `ReplicaGroup` (`repro_torch.serve.replica`);
  * `make_trace` / `replay` / `TraceEvent` / `zipf_rates` /
    `trace_summary` (`repro_torch.serve.trace`).

Tenant engines run on ``cuda`` unless the tier is given ``device="cpu"``.
"""
from repro_torch.serve.admission import (       # noqa: F401
    AdmissionError, DeficitRoundRobin, QueryTicket,
)
from repro_torch.serve.cache import ResultCache               # noqa: F401
from repro_torch.serve.replica import ReplicaGroup            # noqa: F401
from repro_torch.serve.scheduler import (                     # noqa: F401
    RefreshAllocation, RefreshScheduler,
)
from repro_torch.serve.tenant import Tenant, TenantSpec       # noqa: F401
from repro_torch.serve.tier import IMServe, ServedQuery       # noqa: F401
from repro_torch.serve.trace import (                         # noqa: F401
    KIND_DELTA, KIND_QUERY, TraceEvent, make_trace, replay,
    trace_summary, zipf_rates,
)
