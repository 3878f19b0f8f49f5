"""Shared scaffolding of the LM architecture configs
(``repro.configs._lm_common``).  ``lm_smoke_step`` takes a gradient and
waits for the training slice (ROADMAP A9)."""
from __future__ import annotations

from repro_torch.configs.base import ShapeDef


def lm_shapes(*, window: int = 0, arch_note: str = ""):
    """The assigned LM shape set.  ``long_500k`` runs only for sub-quadratic
    archs (sliding-window attention -> fixed-size ring KV cache)."""
    full_attn = window <= 0
    return {
        "train_4k": ShapeDef(
            "train_4k", "train",
            {"seq_len": 4096, "global_batch": 256}),
        "prefill_32k": ShapeDef(
            "prefill_32k", "prefill",
            {"seq_len": 32768, "global_batch": 32}),
        "decode_32k": ShapeDef(
            "decode_32k", "decode",
            {"seq_len": 32768, "global_batch": 128}),
        "long_500k": ShapeDef(
            "long_500k", "decode",
            {"seq_len": 524288, "global_batch": 1},
            skip=full_attn,
            skip_reason=(
                "pure full-attention arch: 500k decode needs a sub-quadratic"
                " attention variant, none specified in the source"
                + (f" ({arch_note})" if arch_note else ""))),
    }
