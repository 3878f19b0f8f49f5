"""Training entry point (``repro.launch.train``): an LM arch's step, the token
stream and a `repro_torch.runtime.TrainLoop` with its checkpoints.

Runs real steps on ``cuda`` unless ``device="cpu"`` (``--device cpu``) is
given; the arch's smoke config by default, its published one with
``--full``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 50 --checkpoint-dir /tmp/ck --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --full --steps 6 --batch 4 --seq-len 4096

A second run on the same ``--checkpoint-dir`` resumes from its newest
checkpoint.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.common import tree_map
from repro_torch.models.transformer import (LMConfig, init_lm,
                                            lm_value_and_grad)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.schedule import cosine_schedule, wsd_schedule
from repro_torch.runtime.loop import LoopConfig, TrainLoop

#: the reference's default checkpoint directory, under this host's
#: temporary directory
DEFAULT_CHECKPOINT_DIR = os.path.join(tempfile.gettempdir(), "repro_ck")


def make_step(cfg: LMConfig, opt_cfg: AdamWConfig, schedule_fn):
    """``step_fn(state, batch) -> (state, {"loss", "grad_norm"})``: the
    loss and its gradient, clipped to global norm 1, and one AdamW step at
    the schedule's rate for ``state["opt"]["step"]``.  The input state is
    left as it is, so the loop can retry a step from it."""

    def step_fn(state, batch):
        tokens, labels = batch
        loss, grads = lm_value_and_grad(state["params"], cfg, tokens, labels)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        lr_scale = schedule_fn(state["opt"]["step"])
        params, opt = adamw_update(state["params"], grads, state["opt"],
                                   opt_cfg, lr_scale)
        return ({"params": params, "opt": opt},
                {"loss": loss, "grad_norm": gnorm})

    return step_fn


def lm_loop(cfg: LMConfig, *, steps: int, batch: int, seq_len: int,
            checkpoint_dir: str, save_every: int, seed: int = 0,
            wsd: bool = False, device=None, inject_fault=None,
            params=None) -> TrainLoop:
    """`train_lm`'s loop over ``cfg``: AdamW at lr 1e-3, the WSD schedule
    with ``wsd`` and the cosine one otherwise, `TokenPipeline` batches
    (int64 on ``device``) and ``init_lm`` from a generator seeded
    ``seed`` on ``device``, or a copy of ``params`` (say the reference's
    carried across by `repro_torch.convert.lm_params_from_jax`)."""
    dev = resolve_device(device)
    opt_cfg = AdamWConfig(lr=1e-3)
    if wsd:
        def schedule_fn(s):
            return wsd_schedule(s, warmup=steps // 10 + 1,
                                stable=int(steps * 0.6),
                                decay=max(int(steps * 0.3), 1))
    else:
        def schedule_fn(s):
            return cosine_schedule(s, warmup=steps // 10 + 1, total=steps)

    pipe = TokenPipeline(vocab=cfg.vocab, batch=batch, seq_len=seq_len,
                         seed=seed)

    def batch_fn(step):
        t, l = pipe.batch_at(step)
        return (torch.from_numpy(t).to(dev, torch.int64),
                torch.from_numpy(l).to(dev, torch.int64))

    def init_fn():
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            start = init_lm(gen, cfg, device=dev)
        else:
            start = tree_map(lambda p: p.detach().to(dev, copy=True),
                             params)
        return {"params": start, "opt": adamw_init(start, opt_cfg)}

    return TrainLoop(
        LoopConfig(total_steps=steps, checkpoint_dir=checkpoint_dir,
                   save_every=save_every),
        make_step(cfg, opt_cfg, schedule_fn), batch_fn, init_fn,
        inject_fault=inject_fault)


def train_lm(arch_id: str, *, smoke: bool = True, steps: int = 100,
             batch: int = 8, seq_len: int = 128,
             checkpoint_dir: str = DEFAULT_CHECKPOINT_DIR,
             save_every: int = 50, seed: int = 0, log=print, device=None,
             params=None):
    """Train ``arch_id`` (its smoke config, or its published one without
    ``smoke``) for ``steps`` steps from ``params`` (None: `lm_loop`'s
    draw); WSD for ``minicpm-2b``, cosine otherwise.  -> ``(state,
    losses, loop)``."""
    arch = get_arch(arch_id)
    cfg = arch.smoke_config if smoke else arch.config
    loop = lm_loop(cfg, steps=steps, batch=batch, seq_len=seq_len,
                   checkpoint_dir=checkpoint_dir, save_every=save_every,
                   seed=seed, wsd=arch_id == "minicpm-2b", device=device,
                   params=params)
    t0 = time.time()
    state = loop.run()
    losses = [float(r.metrics["loss"]) for r in loop.history]
    if losses:
        log(f"[train] {arch_id}: steps={len(loop.history)} "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"({time.time()-t0:.1f}s, recoveries={loop.recoveries})")
    return state, losses, loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--checkpoint-dir", default=DEFAULT_CHECKPOINT_DIR)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    train_lm(args.arch, smoke=args.smoke, steps=args.steps,
             batch=args.batch, seq_len=args.seq_len,
             checkpoint_dir=args.checkpoint_dir, device=args.device)


if __name__ == "__main__":
    main()
