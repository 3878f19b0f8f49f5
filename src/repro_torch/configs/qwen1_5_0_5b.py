"""qwen1.5-0.5b — Qwen1.5-0.5B dense LM with QKV bias
(``repro.configs.qwen1_5_0_5b``).

[hf:Qwen/Qwen1.5-0.5B; hf] — assigned config:
24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936, QKV bias.
"""
from repro_torch.configs._lm_common import lm_shapes, lm_smoke_step
from repro_torch.configs.base import ArchDef, register
from repro_torch.models.transformer import LMConfig, init_lm

FULL = LMConfig(
    name="qwen1.5-0.5b",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab=151936,
    qkv_bias=True,
    dtype="bfloat16",
)

SMOKE = LMConfig(
    name="qwen-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=512,
    qkv_bias=True,
)

ARCH = register(ArchDef(
    arch_id="qwen1.5-0.5b",
    family="lm",
    source="hf:Qwen/Qwen1.5-0.5B",
    config=FULL,
    smoke_config=SMOKE,
    shapes=lm_shapes(window=0, arch_note="full attention, dense"),
    init_fn=init_lm,
    smoke_step=lm_smoke_step,
    technique_applicable=False,
    technique_note="dense LM: no sparse scatter hot path",
))
