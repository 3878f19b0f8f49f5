"""moonshot-v1-16b-a3b — Moonlight-16B-A3B MoE LM
(``repro.configs.moonshot_v1_16b_a3b``).

[hf:moonshotai/Moonlight-16B-A3B; hf] — assigned config:
48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64 experts
top-6.  (With the assigned dims the total parameter count works out to
~28B with ~3.3B active — the "A3B" active size matches; see DESIGN.)
"""
from repro_torch.configs._lm_common import lm_shapes, lm_smoke_step
from repro_torch.configs.base import ArchDef, register
from repro_torch.models.transformer import LMConfig, init_lm

FULL = LMConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840,
    n_experts=64, top_k=6, capacity_factor=1.25,
    dtype="bfloat16",
)

SMOKE = LMConfig(
    name="moonshot-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=48, vocab=512,
    n_experts=8, top_k=2,
)

ARCH = register(ArchDef(
    arch_id="moonshot-v1-16b-a3b",
    family="lm",
    source="hf:moonshotai/Moonlight-16B-A3B",
    config=FULL,
    smoke_config=SMOKE,
    shapes=lm_shapes(window=0, arch_note="full attention, MoE"),
    init_fn=init_lm,
    smoke_step=lm_smoke_step,
    technique_applicable=True,
    technique_note=("partial: MoE token->expert dispatch is a reduce-by-key"
                    " scatter — reuses the repro.sparse one-hot/segment"
                    " machinery (DESIGN §4)"),
))
