"""grok-1-314b — xAI Grok-1 MoE LM (``repro.configs.grok_1_314b``).

[hf:xai-org/grok-1; unverified] — assigned config:
64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8 experts
top-2.
"""
from repro_torch.configs._lm_common import lm_shapes, lm_smoke_step
from repro_torch.configs.base import ArchDef, register
from repro_torch.models.transformer import LMConfig, init_lm

FULL = LMConfig(
    name="grok-1-314b",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072,
    n_experts=8, top_k=2, capacity_factor=1.25,
    dtype="bfloat16",
)

SMOKE = LMConfig(
    name="grok-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=96, vocab=512,
    n_experts=4, top_k=2,
)

ARCH = register(ArchDef(
    arch_id="grok-1-314b",
    family="lm",
    source="hf:xai-org/grok-1",
    config=FULL,
    smoke_config=SMOKE,
    shapes=lm_shapes(window=0, arch_note="full attention, MoE"),
    init_fn=init_lm,
    smoke_step=lm_smoke_step,
    technique_applicable=True,
    technique_note=("partial: MoE dispatch only (DESIGN §4); attention/FFN"
                    " dense"),
))
