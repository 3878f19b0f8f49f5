"""Experiment and architecture configurations (``repro.configs``).

Importing this package registers the architectures the port runs: the
three dense LMs it serves and the FM recsys model (``fm``), served and
trained.  The MoE archs (moonshot-v1-16b-a3b, grok-1-314b) and the GNNs
wait for their slices (ROADMAP A9)::

    from repro_torch.configs import get_arch
    cfg = get_arch("qwen1.5-0.5b").config
"""
from repro_torch.configs.base import (
    ArchDef, ShapeDef, all_archs, get_arch, register,
)

# importing the modules registers the archs
from repro_torch.configs import (          # noqa: F401
    fm,
    h2o_danube_3_4b,
    minicpm_2b,
    qwen1_5_0_5b,
)

__all__ = ["ArchDef", "ShapeDef", "all_archs", "get_arch", "register"]
