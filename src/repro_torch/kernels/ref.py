"""Plain PyTorch versions of every kernel (``repro.kernels.ref``).

Each is defined beside its kernel (``<kernel>_plain`` in the kernel's
module) and named here as the reference's ``*_ref``: the CPU path of
`repro_torch.kernels.ops` and the yardstick the CUDA kernels are held to
on the card.
"""
from repro_torch.kernels.coins import ic_sparse_hits_plain as ic_sparse_hits_ref
from repro_torch.prng import uniform as uniform_draw_ref
from repro_torch.kernels.commit import (
    arena_commit_packed_plain as arena_commit_packed_ref,
    arena_commit_plain as arena_commit_ref,
)
from repro_torch.kernels.coverage_matvec import (
    coverage_matvec_plain as coverage_matvec_ref,
)
from repro_torch.kernels.flash_attention import (
    flash_attention_backward_plain,
    flash_attention_plain as attention_ref,
)
from repro_torch.kernels.fm_interaction import (
    fm_gather_interaction_plain as fm_gather_interaction_ref,
    fm_interaction_plain as fm_interaction_ref,
)
from repro_torch.kernels.fused_select import (
    fused_select_plain as fused_select_ref,
)
from repro_torch.kernels.ic_frontier import (
    ic_frontier_step_plain as ic_frontier_ref,
)
from repro_torch.kernels.packed_count import (
    packed_count_plain as packed_count_ref,
    token_count_plain as token_count_ref,
)

__all__ = ["arena_commit_packed_ref", "arena_commit_ref", "attention_ref",
           "flash_attention_backward_plain",
           "coverage_matvec_ref", "fm_gather_interaction_ref",
           "fm_interaction_ref", "fused_select_ref",
           "ic_frontier_ref", "ic_sparse_hits_ref",
           "packed_count_ref", "token_count_ref", "uniform_draw_ref"]
