"""h2o-danube-3-4b — H2O.ai Danube3 dense LM with sliding-window attention
(``repro.configs.h2o_danube_3_4b``).

[arXiv:2401.16818; unverified] — assigned config:
24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, llama+mistral mix,
SWA.  Window = 4096 (the Mistral-style SWA the Danube line inherits).

The SWA ring-buffer KV cache keeps decode cost and cache size O(window).
"""
from repro_torch.configs._lm_common import lm_shapes, lm_smoke_step
from repro_torch.configs.base import ArchDef, register
from repro_torch.models.transformer import LMConfig, init_lm

FULL = LMConfig(
    name="h2o-danube-3-4b",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000,
    window=4096,
    dtype="bfloat16",
)

SMOKE = LMConfig(
    name="danube-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512,
    window=8,
)

ARCH = register(ArchDef(
    arch_id="h2o-danube-3-4b",
    family="lm",
    source="arXiv:2401.16818",
    config=FULL,
    smoke_config=SMOKE,
    shapes=lm_shapes(window=4096, arch_note="SWA window 4096"),
    init_fn=init_lm,
    smoke_step=lm_smoke_step,
    technique_applicable=False,
    technique_note="dense LM: no sparse scatter hot path",
))
