"""GraphSAGE node classification on a planted-partition graph with REAL
neighbor sampling (the minibatch_lg training pattern at example scale).

    PYTHONPATH=src python examples_torch/gnn_node_classification.py \\
        [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import prng
from repro_torch.data.graph_feats import synthetic_node_features
from repro_torch.device import resolve_device
from repro_torch.graphs import rmat_graph
from repro_torch.graphs.sampler import neighbor_sampler
from repro_torch.models.common import value_and_grad
from repro_torch.models.gnn.graphsage import (
    SageConfig, forward_blocks, init_sage, loss_blocks,
)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


def main(n_nodes=2_000, n_edges=16_000, n_classes=5, d_feat=32,
         steps=150, batch=64, *, device=None, params=None) -> dict:
    """Train for ``steps`` AdamW steps of ``batch`` seeds, both hops
    sampled every step.  ``params`` (optional) are the initial
    parameters, for example the reference's carried across by
    `repro_torch.convert.gnn_params_from_jax`; by default they are drawn
    from a generator seeded 0."""
    dev = resolve_device(device)
    g = rmat_graph(n_nodes, n_edges, seed=0).to(dev)
    feats_np, labels_np = synthetic_node_features(
        g.n, d_feat, n_classes, seed=0, noise=1.5)
    pad = np.zeros((1, d_feat), feats_np.dtype)
    table = torch.from_numpy(np.concatenate([feats_np, pad])).to(dev)
    labels = torch.from_numpy(labels_np).to(dev, torch.int64)  # sentinel n

    cfg = SageConfig(n_layers=2, d_hidden=64, d_feat=d_feat,
                     n_classes=n_classes, sample_sizes=(10, 5))
    if params is None:
        params = init_sage(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    opt_cfg = AdamWConfig(lr=3e-3, weight_decay=0.0)
    opt = adamw_init(params, opt_cfg)
    f1, f2 = cfg.sample_sizes

    def step(params, opt, key, seeds):
        k1, k2 = prng.split(key)
        n1 = neighbor_sampler(k1, g.dst_offsets, g.in_src, seeds, f1)
        n2 = neighbor_sampler(k2, g.dst_offsets, g.in_src,
                              n1.reshape(-1), f2)
        x = (table[seeds], table[n1.long()], table[n2.long()])
        loss, grads = value_and_grad(loss_blocks, params, cfg, *x,
                                     labels[seeds])
        params, opt = adamw_update(params, grads, opt, opt_cfg)
        with torch.no_grad():
            logits = forward_blocks(params, cfg, *x)
        acc = (logits.argmax(-1) == labels[seeds]).float().mean()
        return params, opt, loss, acc

    key = prng.PRNGKey(1)
    accs, losses = [], []
    for i in range(steps):
        key, k1, k2 = prng.split(key, 3)
        seeds = prng.randint(k1, (batch,), 0, g.n, device=dev).long()
        params, opt, loss, acc = step(params, opt, k2, seeds)
        losses.append(loss)
        accs.append(acc)
        if i % 30 == 0:
            print(f"step {i:4d}  loss {float(loss):.4f}  "
                  f"minibatch acc {float(acc):.3f}")
    losses = torch.stack(losses).tolist()
    accs = torch.stack(accs).tolist()
    first, last = float(np.mean(accs[:10])), float(np.mean(accs[-10:]))
    print(f"[gnn] minibatch accuracy {first:.3f} -> {last:.3f}")
    assert last > first + 0.1, "accuracy did not improve"
    print("[gnn] OK")
    return {"steps": steps, "losses": losses, "accs": accs,
            "acc_first10": first, "acc_last10": last}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
