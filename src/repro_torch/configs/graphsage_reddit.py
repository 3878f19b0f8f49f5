"""graphsage-reddit: GraphSAGE with mean aggregator, 25-10 fan-out
(``repro.configs.graphsage_reddit``).

[arXiv:1706.02216; paper]: assigned config n_layers=2 d_hidden=128
aggregator=mean sample_sizes=25-10.  The ``minibatch_lg`` cell uses the
native sampled-block form (its own fan-out 15-10 per the shape
assignment); the full-graph cells use the edge-list form.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.configs._gnn_common import gnn_shapes, grad_norm
from repro_torch.configs.base import ArchDef, register
from repro_torch.models.common import value_and_grad
from repro_torch.models.gnn.graphsage import (
    SageConfig, forward_blocks, forward_edges, init_sage, loss_blocks,
)

FULL = SageConfig(
    n_layers=2, d_hidden=128, d_feat=602, n_classes=41,
    aggregator="mean", sample_sizes=(25, 10),
)

SMOKE = SageConfig(
    n_layers=2, d_hidden=16, d_feat=12, n_classes=5,
    aggregator="mean", sample_sizes=(3, 2),
)


def _smoke_step(params, cfg: SageConfig, key) -> dict:
    """The reference's smoke step on ``params``' device: block-mode logits,
    the loss and its gradients (``grads``, a tree like ``params``, and
    their global norm), and edge-mode logits on a random graph.  ``key``
    is a threefry key (`repro_torch.prng`): the inputs are the
    reference's draws (the normals to ``erfinv``'s last bits)."""
    dev = params["w_out"].device
    k1, k2, k3, k4, k5 = prng.split(key, 5)
    B, (f1, f2) = 4, cfg.sample_sizes
    x_seed = prng.normal(k1, (B, cfg.d_feat), device=dev)
    x_n1 = prng.normal(k2, (B, f1, cfg.d_feat), device=dev)
    x_n2 = prng.normal(k3, (B * f1, f2, cfg.d_feat), device=dev)
    labels = prng.randint(k4, (B,), 0, cfg.n_classes, device=dev)
    with torch.no_grad():
        logits = forward_blocks(params, cfg, x_seed, x_n1, x_n2)
    loss, grads = value_and_grad(loss_blocks, params, cfg, x_seed, x_n1,
                                 x_n2, labels)
    n, e = 20, 60
    nf = prng.normal(k5, (n, cfg.d_feat), device=dev)
    es = prng.randint(k1, (e,), 0, n, device=dev)
    ed = prng.randint(k2, (e,), 0, n, device=dev)
    with torch.no_grad():
        logits_full = forward_edges(params, cfg, nf, es, ed, n)
    return {"logits": logits, "logits_full": logits_full, "loss": loss,
            "grad_norm": grad_norm(grads), "grads": grads}


ARCH = register(ArchDef(
    arch_id="graphsage-reddit",
    family="gnn",
    source="arXiv:1706.02216",
    config=FULL,
    smoke_config=SMOKE,
    shapes=gnn_shapes(),
    init_fn=init_sage,
    smoke_step=_smoke_step,
    technique_applicable=True,
    technique_note=("direct: mean-aggregate = gather -> segment reduce;"
                    " the neighbour sampler (graphs/sampler.py) feeds the"
                    " minibatch cells"),
))
