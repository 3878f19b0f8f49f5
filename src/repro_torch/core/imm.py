"""``imm(graph, cfg)`` — the one-shot IMM entry point
(``repro.core.imm``): a fresh `InfluenceEngine` run once.  Runs on
``cuda`` unless ``device="cpu"`` is passed."""
from __future__ import annotations

from repro_torch.core.engine import (          # noqa: F401  (re-exported)
    IMMConfig, IMMResult, InfluenceEngine, Selection,
)
from repro_torch.graphs.csr import Graph


def imm(graph: Graph, cfg: IMMConfig = None, *, device=None) -> IMMResult:
    """Run IMM Algorithm 1 end to end and return the seed set."""
    return InfluenceEngine(graph, cfg if cfg is not None else IMMConfig(),
                           device=device).run()
