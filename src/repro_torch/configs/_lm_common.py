"""Shared scaffolding of the five LM architecture configs
(``repro.configs._lm_common``): the shape cells and ``lm_smoke_step``,
the smoke hook every LM arch shares."""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.configs.base import ShapeDef
from repro_torch.models.transformer import (
    LMConfig, decode_step, init_kv_cache, lm_value_and_grad, prefill,
    tree_leaves,
)


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


def lm_smoke_step(params, cfg: LMConfig, key) -> dict:
    """One forward + backward + decode on tiny shapes, on ``params``'
    device: the loss and the gradients' global norm on 2 x 16 tokens (the
    last label masked), the prefill logits and one decode step's token.
    ``key`` is a threefry key (`repro_torch.prng`), so the tokens are the
    reference's."""
    dev = params["embed"].device
    tokens = prng.randint(key, (2, 16), 0, cfg.vocab, device=dev)
    labels = torch.cat([tokens[:, 1:], torch.full(
        (2, 1), -1, dtype=tokens.dtype, device=dev)], dim=1)
    loss, grads = lm_value_and_grad(params, cfg, tokens, labels)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for _, g in tree_leaves(grads)))
    with torch.no_grad():
        logits, _ = prefill(params, cfg, tokens)
        dc = init_kv_cache(cfg, 2, max(cfg.window, 32) if cfg.window else 32,
                           device=dev)
        nxt, _ = decode_step(params, cfg, dc, tokens[:, :1])
    return {"loss": loss, "grad_norm": gnorm, "prefill_logits": logits,
            "next_token": nxt}

