"""Serving entry points (``repro.launch.serve``).

``LMServer``: batched greedy generation with a KV cache on one device —
prefill (one ``flash_attention`` launch per layer on the card), a replay
of the prompt through `decode_step` that seeds the decode cache, then one
`decode_step` per generated token::

    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \
        --arch qwen1.5-0.5b --device cpu

The CLI serves the arch's smoke configuration, as the reference's does,
and runs on ``cuda`` unless ``--device cpu`` is given.  The influence
workloads of the reference's module (``--workload im``, ``--workload
tier``) are not ported yet and raise naming ROADMAP A6 and A7.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.models.transformer import (
    LMConfig, decode_step, init_kv_cache, init_lm, prefill,
)


class LMServer:
    """Minimal batched server: submit token prompts, get continuations.

    ``params`` default to `init_lm` on a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (``cuda`` unless told otherwise; without a GPU
    that raises unless ``device="cpu"``)."""

    def __init__(self, cfg: LMConfig, params=None, *, max_len: int = 256,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_lm(gen, cfg, device=self.device)
        self.params = params
        self.max_len = max_len

    def prefill(self, prompts: torch.Tensor):
        """``(last-position logits (B, V), prefill's cache)``."""
        return prefill(self.params, self.cfg, prompts)

    def seed_cache(self, prompts: torch.Tensor):
        """Replay the prompt through `decode_step` into a fresh decode
        cache (ring-buffer handling for sliding windows stays in one
        place); returns ``(the last step's next token (B, 1), cache)``."""
        B, S = prompts.shape
        cache_len = self.cfg.window if self.cfg.window > 0 else self.max_len
        cache = init_kv_cache(self.cfg, B, cache_len, device=self.device)
        tok = None
        for i in range(S):
            tok, cache = decode_step(self.params, self.cfg, cache,
                                     prompts[:, i:i + 1])
        return tok, cache

    def decode(self, cache: dict, tok: torch.Tensor, n_tokens: int):
        """``n_tokens`` greedy tokens from ``tok (B, 1)`` on, ``(B, n)``."""
        out = []
        for _ in range(n_tokens):
            out.append(tok)
            tok, cache = decode_step(self.params, self.cfg, cache, tok)
        return torch.cat(out, dim=1)

    def generate(self, prompts, n_tokens: int = 16) -> torch.Tensor:
        """prompts: (B, S) int32 -> (B, n_tokens) greedy continuation.
        Prefill's logits give the first token; its cache is discarded and
        the decode cache is seeded by replaying the prompt, as in the
        reference."""
        prompts = torch.as_tensor(prompts, device=self.device)
        logits, _ = self.prefill(prompts)
        _, cache = self.seed_cache(prompts)
        tok = torch.argmax(logits, dim=-1)[:, None].to(prompts.dtype)
        return self.decode(cache, tok, n_tokens)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _main_lm(args) -> torch.Tensor:
    cfg = get_arch(args.arch).smoke_config
    server = LMServer(cfg, device=args.device)
    prompts = prng.randint(prng.PRNGKey(1), (args.batch, args.prompt_len),
                           0, cfg.vocab, device=server.device)
    t0 = time.time()
    out = server.generate(prompts, args.gen)
    _sync(server.device)
    dt = time.time() - t0
    print(f"[serve] {args.arch} on {server.device}: generated "
          f"{tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print(out[0].tolist())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="lm", choices=("lm", "im", "tier"))
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default) or 'cpu' (the "
                         "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    if args.workload == "im":
        raise NotImplementedError(
            "--workload im: IMServer and the streaming engine are not "
            "ported yet (ROADMAP A6)")
    if args.workload == "tier":
        raise NotImplementedError(
            "--workload tier: the IMServe tier is not ported yet "
            "(ROADMAP A7)")
    return _main_lm(args)


if __name__ == "__main__":
    main()
