"""End-to-end LM training example: ~100M-parameter qwen-family model for a
few hundred steps with checkpoint/restart and the WSD/cosine schedule.
Attention's forward and backward run the f32 ``flash_attention`` kernels
on the card.

    PYTHONPATH=src python examples_torch/train_lm.py      # ~100M, 200 steps
    PYTHONPATH=src python examples_torch/train_lm.py --tiny --device cpu

A second run on the same ``--checkpoint-dir`` resumes from its newest
checkpoint.
"""
import argparse
import os
import tempfile

from repro_torch.configs import base
from repro_torch.configs._lm_common import lm_shapes, lm_smoke_step
from repro_torch.launch.train import train_lm
from repro_torch.models.transformer import LMConfig, init_lm

#: the checkpoints' directory unless ``--checkpoint-dir`` names another
DEFAULT_CHECKPOINT_DIR = os.path.join(tempfile.gettempdir(),
                                      "repro_torch_train_lm")


def register_100m():
    """A ~100M-parameter member of the qwen family (same code path as the
    full assigned configs).  Registering it again replaces the entry."""
    cfg = LMConfig(
        name="qwen-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=8, d_ff=1408, vocab=32_000, qkv_bias=True)
    arch = base.ArchDef(
        arch_id="qwen-100m", family="lm", source="examples/train_lm.py",
        config=cfg, smoke_config=cfg, shapes=lm_shapes(),
        init_fn=init_lm, smoke_step=lm_smoke_step)
    base.register(arch)
    print(f"[train_lm] params: {cfg.param_count()/1e6:.1f}M")
    return arch


def main(argv=None, *, params=None) -> dict:
    """The run the flags ask for; ``params`` (optional) are the initial
    parameters, for example the reference's carried across by
    `repro_torch.convert.lm_params_from_jax`."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--checkpoint-dir", default=DEFAULT_CHECKPOINT_DIR)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.tiny:
        arch_id, steps = "qwen1.5-0.5b", args.steps or 60
        state, losses, loop = train_lm(
            arch_id, smoke=True, steps=steps, batch=8, seq_len=64,
            checkpoint_dir=args.checkpoint_dir, device=args.device,
            params=params)
    else:
        arch_id = register_100m().arch_id
        steps = args.steps or 200
        state, losses, loop = train_lm(
            arch_id, smoke=True, steps=steps, batch=8, seq_len=256,
            checkpoint_dir=args.checkpoint_dir, save_every=50,
            device=args.device, params=params)
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    print(f"[train_lm] first-10 loss {first:.4f} -> "
          f"last-10 loss {last:.4f}")
    assert sum(losses[-10:]) < sum(losses[:10]), "loss did not improve"
    print("[train_lm] OK — loss improved; checkpoints in",
          args.checkpoint_dir)
    return {"arch": arch_id, "steps": len(losses), "losses": losses,
            "first10": first, "last10": last,
            "step_s": [r.step_time for r in loop.history],
            "checkpoint_dir": args.checkpoint_dir}


if __name__ == "__main__":
    main()
