"""IMM experiment configs for the paper's 8 SNAP graphs (Table I / III),
as in ``repro.configs.imm_snap``: the graph stats with the paper's
hyper-parameters (k=50, eps=0.5) and the benchmark shrink factor.  The
mesh helpers wait for the sharding slice (ROADMAP A8)."""
from __future__ import annotations

import dataclasses

from repro_torch.core.engine import IMMConfig
from repro_torch.graphs.datasets import SNAP_STATS

# seed-set sizes an influence campaign sweeps against one sampled store
CAMPAIGN_KS = (5, 10, 20, 50)


@dataclasses.dataclass(frozen=True)
class IMMExperiment:
    graph: str
    n: int
    m: int
    directed: bool
    cfg_ic: IMMConfig
    cfg_lt: IMMConfig
    cfg_wc: IMMConfig
    cfg_gt: IMMConfig
    bench_scale: float        # benchmark shrink factor
    campaign_ks: tuple = CAMPAIGN_KS


def _mk(graph: str, bench_scale: float) -> IMMExperiment:
    n, m, directed = SNAP_STATS[graph]
    return IMMExperiment(
        graph=graph, n=n, m=m, directed=directed,
        cfg_ic=IMMConfig(k=50, eps=0.5, model="IC"),
        cfg_lt=IMMConfig(k=50, eps=0.5, model="LT"),
        cfg_wc=IMMConfig(k=50, eps=0.5, model="WC"),
        cfg_gt=IMMConfig(k=50, eps=0.5, model="GT"),
        bench_scale=bench_scale,
    )


IMM_EXPERIMENTS = {
    "com-Amazon":  _mk("com-Amazon", 0.01),
    "com-YouTube": _mk("com-YouTube", 0.004),
    "com-DBLP":    _mk("com-DBLP", 0.01),
    "com-LJ":      _mk("com-LJ", 0.001),
    "soc-Pokec":   _mk("soc-Pokec", 0.002),
    "as-Skitter":  _mk("as-Skitter", 0.002),
    "web-Google":  _mk("web-Google", 0.004),
    "Twitter7":    _mk("Twitter7", 0.0001),
}
