"""fm — Factorization Machine (Rendle, ICDM'10) (``repro.configs.fm``).

[ICDM'10 (Rendle); paper] — assigned config: n_sparse=39 embed_dim=10,
interaction=fm-2way via the O(nk) sum-square trick.

Embedding tables: 39 categorical fields x 1M rows each (Criteo scale)
share one concatenated 39M x 10 table (1.56 GB in f32) on one device.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.configs.base import ArchDef, ShapeDef, register
from repro_torch.models.recsys.fm import (
    FMConfig, fm_logits, fm_retrieval_scores, fm_value_and_grad, init_fm,
)

FULL = FMConfig(n_sparse=39, embed_dim=10, vocab_per_field=1_000_000)

SMOKE = FMConfig(n_sparse=6, embed_dim=4, vocab_per_field=128)


def fm_shapes():
    return {
        "train_batch": ShapeDef(
            "train_batch", "train", {"batch": 65_536}),
        "serve_p99": ShapeDef(
            "serve_p99", "serve", {"batch": 512},
            note="online-inference latency shape"),
        "serve_bulk": ShapeDef(
            "serve_bulk", "serve", {"batch": 262_144},
            note="offline scoring"),
        "retrieval_cand": ShapeDef(
            "retrieval_cand", "serve",
            {"batch": 1, "n_candidates": 1_000_000},
            note="one query vs 1M candidates as a single batched mat-vec"),
    }


def _smoke_step(params, cfg: FMConfig, key) -> dict:
    """The reference's smoke step on ``params``' device: 32 requests'
    logits, the loss and its gradients, one user's scores against 64
    candidates and the gradients' global norm.  ``key`` is a threefry key
    (`repro_torch.prng`), so the ids and labels are the reference's."""
    k1, k2, k3 = prng.split(key, 3)
    dev = params["v"].device
    idx = prng.randint(k1, (32, cfg.n_sparse), 0, cfg.vocab_per_field,
                       device=dev)
    labels = (prng.uniform(k2, (32,), device=dev) < 0.5).to(torch.float32)
    logits = fm_logits(params, cfg, idx)
    loss, grads = fm_value_and_grad(params, cfg, idx, labels)
    cand = prng.randint(k3, (64,), 0, cfg.total_rows, device=dev)
    scores = fm_retrieval_scores(params, cfg, idx[0, :4], cand)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in grads.values()))
    return {"logits": logits, "loss": loss, "scores": scores,
            "grad_norm": gnorm}


ARCH = register(ArchDef(
    arch_id="fm",
    family="recsys",
    source="ICDM'10 (Rendle)",
    config=FULL,
    smoke_config=SMOKE,
    shapes=fm_shapes(),
    init_fn=init_fm,
    smoke_step=_smoke_step,
    technique_applicable=True,
    technique_note=("direct: EmbeddingBag = take + segment_sum (the counter"
                    " op); row-sharded tables = paper C2 NUMA interleaving;"
                    " dense-vs-sparse candidate scoring = C4 (DESIGN §4)"),
))
