"""Experiment and architecture configurations (``repro.configs``).

Importing this package registers the three dense LM architectures the
port serves; the MoE archs (moonshot-v1-16b-a3b, grok-1-314b), the GNNs
and the recsys model wait for their slices (ROADMAP A9)::

    from repro_torch.configs import get_arch
    cfg = get_arch("qwen1.5-0.5b").config
"""
from repro_torch.configs.base import (
    ArchDef, ShapeDef, all_archs, get_arch, register,
)

# importing the modules registers the archs
from repro_torch.configs import (          # noqa: F401
    h2o_danube_3_4b,
    minicpm_2b,
    qwen1_5_0_5b,
)

__all__ = ["ArchDef", "ShapeDef", "all_archs", "get_arch", "register"]
