"""Experiment and architecture configurations (``repro.configs``).

Importing this package registers the architectures the port runs: the
five LMs, served and trained (three dense: qwen1.5-0.5b, h2o-danube-3-4b,
minicpm-2b; two MoE: moonshot-v1-16b-a3b, grok-1-314b), the four GNNs,
trained (graphsage-reddit, graphcast, egnn, equiformer-v2), and the FM
recsys model (``fm``), served and trained::

    from repro_torch.configs import get_arch
    cfg = get_arch("qwen1.5-0.5b").config

``all_cells`` lists every (arch, shape) cell and ``IMM_DRYRUN_CELLS`` the
three IMM production cells, which ``repro_torch.launch.steps`` builds.
"""
from repro_torch.configs.base import (
    ArchDef, ShapeDef, all_archs, all_cells, get_arch, register,
)

# importing the modules registers the archs
from repro_torch.configs import (          # noqa: F401
    egnn,
    equiformer_v2,
    fm,
    graphcast,
    graphsage_reddit,
    grok_1_314b,
    h2o_danube_3_4b,
    minicpm_2b,
    moonshot_v1_16b_a3b,
    qwen1_5_0_5b,
)

from repro_torch.configs.imm_snap import IMM_DRYRUN_CELLS, IMM_EXPERIMENTS

__all__ = ["ArchDef", "ShapeDef", "all_archs", "all_cells", "get_arch",
           "register", "IMM_EXPERIMENTS", "IMM_DRYRUN_CELLS"]
