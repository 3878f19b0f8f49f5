"""FM CTR training + the three serving modes (p99 / bulk / retrieval).

Training runs the ``fm_interaction`` kernel under each step's gathers;
a serving call is one ``fm_gather_interaction`` launch (gathers and pair
term fused).

    PYTHONPATH=src python examples_torch/recsys_ctr.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.data.clicks import synthetic_click_batches
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.recsys.fm import (
    FMConfig, fm_logits, fm_retrieval_scores, fm_value_and_grad, init_fm,
)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


def main(steps=200, *, device=None, params=None) -> dict:
    """Train for ``steps`` steps of 1,024 clicks, then serve.  ``params``
    (optional) are the initial parameters, for example the reference's
    carried across by `repro_torch.convert.fm_params_from_jax`; by
    default they are drawn from a generator seeded 0."""
    dev = resolve_device(device)
    cfg = FMConfig(n_sparse=8, embed_dim=8, vocab_per_field=500)
    if params is None:
        params = init_fm(cfg, generator=torch.Generator(device=dev)
                         .manual_seed(0), device=dev)
    opt_cfg = AdamWConfig(lr=0.01, weight_decay=0.0)
    opt = adamw_init(params, opt_cfg)

    losses = []
    for idx, labels in synthetic_click_batches(
            cfg.n_sparse, cfg.vocab_per_field, 1024, steps, dim=4, seed=0):
        loss, grads = fm_value_and_grad(
            params, cfg, torch.from_numpy(idx).to(dev),
            torch.from_numpy(labels).to(dev))
        params, opt = adamw_update(params, grads, opt, opt_cfg)
        losses.append(loss)
    losses = torch.stack(losses).tolist()
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"[recsys] CTR loss {first:.4f} -> {last:.4f}")
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    out = {"steps": steps, "losses": losses, "loss_first10": first,
           "loss_last10": last}

    # --- serving modes (the assigned shape set, example scale) ---
    for name, B in (("serve_p99", 512), ("serve_bulk", 8192)):
        idx = prng.randint(prng.PRNGKey(1), (B, cfg.n_sparse), 0,
                           cfg.vocab_per_field, device=dev)
        fm_logits(params, cfg, idx)                   # warm-up
        synchronize(dev)
        t0 = time.perf_counter()
        logits = fm_logits(params, cfg, idx)
        synchronize(dev)
        dt = time.perf_counter() - t0
        out[name] = {"batch": B, "ms": dt * 1e3, "preds_per_s": B / dt,
                     "finite": bool(torch.isfinite(logits).all())}
        print(f"[recsys] {name}: batch {B} in {dt*1e3:.2f} ms "
              f"({B/dt:.0f} preds/s)")

    # retrieval: one user context against many candidates as one mat-vec
    n_cand = 100_000
    cands = prng.randint(prng.PRNGKey(2), (n_cand,), 0, cfg.total_rows,
                         device=dev)
    user = torch.tensor([3, 77, 150, 9], dtype=torch.int32, device=dev)
    fm_retrieval_scores(params, cfg, user, cands)     # warm-up
    synchronize(dev)
    t0 = time.perf_counter()
    scores = fm_retrieval_scores(params, cfg, user, cands)
    synchronize(dev)
    dt = time.perf_counter() - t0
    top = np.argsort(scores.cpu().numpy())[-5:][::-1]
    out["retrieval_cand"] = {"candidates": n_cand, "ms": dt * 1e3,
                             "top5": top.tolist()}
    print(f"[recsys] retrieval_cand: {n_cand:,} candidates in "
          f"{dt*1e3:.2f} ms; top-5 rows {top.tolist()}")
    print("[recsys] OK")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
