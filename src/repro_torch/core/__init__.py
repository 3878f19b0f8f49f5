"""IMM core: sampler, store, fused extender, selection, engine."""
from repro_torch.core.engine import (
    IMMConfig, IMMResult, InfluenceEngine, Selection, resolve_device,
)
from repro_torch.core.imm import imm

__all__ = ["IMMConfig", "IMMResult", "InfluenceEngine", "Selection",
           "imm", "resolve_device"]
