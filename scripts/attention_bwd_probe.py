#!/usr/bin/env python3
"""Time the attention backward kernels on the card, alone.

    python3 scripts/attention_bwd_probe.py [--repeats 3] [--yardsticks]
        [--root DIR]

Builds the port's kernels from ``DIR/src`` (default: this checkout) and
times ``flash_attention_backward_cuda`` (CUDA events, the mean of 20
calls after 3 warm-ups, ``--repeats`` times) at ``chip_smoke.py``'s
backward shapes, ``ATTN_BWD_TRAIN`` (Qwen1.5-0.5B's training shape) and
``ATTN_BWD_SHAPES`` (grok-1's heads, h2o-danube-3's with its window,
qwen-100m's in f32), beside each shape's bound from ``chip_smoke.py``'s
``attention_bwd_bound`` (the gradient's 10 D flops an admitted pair at
the roofline's h100 rate for the dtype); with ``--yardsticks``, each
repeat also times ``chip_smoke.py``'s ``attention_bwd_yardsticks`` there
(the plain backward and SDPA's backward alone).  Prints one JSON line
with the card's name and power limit.  Run it from two checkouts in one call to
compare two versions on one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--yardsticks", action="store_true")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("attention_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(args.root, "src"), args.root]
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa

    chip_smoke.load_peaks()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": args.root, "nvidia_smi": smi}
    for name, B, Hq, Hkv, S, D, window, dtype in (
            (chip_smoke.ATTN_BWD_TRAIN,) + chip_smoke.ATTN_BWD_SHAPES):
        def draw(h):
            return torch.randn((B, h, S, D), generator=gen,
                               device="cuda").to(getattr(torch, dtype))

        q, k, v, dout = draw(Hq), draw(Hkv), draw(Hkv), draw(Hq)
        _, lse = fa.forward_cuda(q, k, v, window=window, with_lse=True)

        def call():
            return fa.flash_attention_backward_cuda(q, k, v, lse, dout,
                                                    window=window)

        runs, yardsticks = [], []
        for _ in range(args.repeats):
            if args.yardsticks:
                yardsticks.append(chip_smoke.attention_bwd_yardsticks(
                    torch, q, k, v, dout, window))
            for _ in range(3):
                call()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(20):
                call()
            t1.record()
            torch.cuda.synchronize()
            runs.append(t0.elapsed_time(t1) / 20)
        bound_ms, _, design_ms, _ = chip_smoke.attention_bwd_bound(
            B, Hq, Hkv, S, D, window, f32=dtype == "float32")
        out[name] = dict(shape=[B, Hq, Hkv, S, D], window=window,
                         dtype=dtype, ms=runs, bound_ms=bound_ms,
                         design_bound_ms=design_ms)
        if yardsticks:
            out[name].update(plain_ms=[y[0] for y in yardsticks],
                             library_ms=[y[1] for y in yardsticks])
        del q, k, v, dout, lse
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
