"""minicpm-2b — MiniCPM-2B dense LM with muP-style scaling
(``repro.configs.minicpm_2b``).

[arXiv:2404.06395; hf] — assigned config:
40L d_model=2304 36H (GQA kv=36) d_ff=5760 vocab=122753.

MiniCPM's muP constants (paper §3): embedding scale 12, residual scale
1.4/sqrt(n_layers), logit scale 1/(d_model/256).
"""
from repro_torch.configs._lm_common import lm_shapes, lm_smoke_step
from repro_torch.configs.base import ArchDef, register
from repro_torch.models.transformer import LMConfig, init_lm

FULL = LMConfig(
    name="minicpm-2b",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab=122753,
    emb_scale=12.0,
    residual_scale=1.4 / (40 ** 0.5),
    logit_scale=1.0 / (2304 / 256),
    dtype="bfloat16",
)

SMOKE = LMConfig(
    name="minicpm-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab=512,
    emb_scale=12.0,
    residual_scale=1.4 / (2 ** 0.5),
    logit_scale=0.25,
)

ARCH = register(ArchDef(
    arch_id="minicpm-2b",
    family="lm",
    source="arXiv:2404.06395",
    config=FULL,
    smoke_config=SMOKE,
    shapes=lm_shapes(window=0, arch_note="full attention, dense"),
    init_fn=init_lm,
    smoke_step=lm_smoke_step,
    technique_applicable=False,
    technique_note="dense LM: no sparse scatter hot path",
))
