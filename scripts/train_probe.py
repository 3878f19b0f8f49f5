#!/usr/bin/env python3
"""Where the training runtime's time goes on the card, apart from the
smoke: checkpoint I/O and a small model's step.

    python3 scripts/train_probe.py [--gib 6] [--steps 30]

1. Checkpoint I/O on a host tree of ``--gib`` GiB (43 leaves, the shape
   of Qwen1.5-0.5B's training state): ``np.savez`` against the port's
   ``checkpoint.npz.write_npz``, ``np.load`` against ``read_npz``, and a
   raw ``write`` of the same bytes, each into the temporary directory
   (the page cache warm for the reads), with the disk's free space.
2. examples/train_lm.py's ``qwen-100m`` (f32, 8 x 256) through
   ``launch.train.lm_loop``: the step's host ms, its device-busy ms and
   launches under ``torch.profiler``, and the host ops that take the
   most CPU time.

Prints one JSON line per part, the card's name and power limit last.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def checkpoint_io(gib: float) -> dict:
    import numpy as np

    from repro_torch.checkpoint.npz import read_npz, write_npz

    rng = np.random.default_rng(0)
    total = int(gib * (1 << 30))
    # the state's leaf sizes: a few large leaves and many small ones
    weights = np.array([16.0] * 3 + [1.0] * 40)
    sizes = (weights / weights.sum() * total).astype(np.int64)
    tree = {f"leaf{i:02d}": rng.integers(0, 255, n, dtype=np.uint8)
            for i, n in enumerate(sizes)}
    root = tempfile.mkdtemp(prefix="train_probe_")
    out = dict(bytes=int(sizes.sum()),
               disk_free=shutil.disk_usage(root).free)
    try:
        def timed(key, fn):
            t = time.perf_counter()
            fn()
            out[key] = time.perf_counter() - t

        a, b, c = (os.path.join(root, n) for n in ("a.npz", "b.npz", "c"))
        timed("savez_s", lambda: np.savez(a, **tree))
        timed("write_npz_s", lambda: write_npz(b, tree))

        def raw():
            with open(c, "wb") as f:
                for v in tree.values():
                    f.write(memoryview(v))

        timed("raw_write_s", raw)

        def np_load():
            with np.load(a) as z:
                return {k: z[k] for k in z.files}

        timed("np_load_s", np_load)
        timed("read_npz_s", lambda: read_npz(b))
        got = read_npz(a)
        out["read_npz_of_savez_equal"] = all(
            np.array_equal(got[k], v) for k, v in tree.items())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def small_step(steps: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch.train import lm_loop
    from repro_torch.models.transformer import LMConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LMConfig(name="qwen-100m", n_layers=8, d_model=512, n_heads=8,
                   n_kv_heads=8, d_ff=1408, vocab=32_000, qkv_bias=True)
    root = tempfile.mkdtemp(prefix="train_probe_")
    try:
        loop = lm_loop(cfg, steps=steps, batch=8, seq_len=256,
                       checkpoint_dir=root, save_every=10 ** 9,
                       device="cuda")
        loop.monitor.threshold = float("inf")
        state = loop.run()
        ms = sorted(r.step_time * 1e3 for r in loop.history[3:])
        batch = loop.batch_fn(0)
        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            loop.step_fn(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        events = prof.key_averages()

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))

        busy = sum(dev_us(e) for e in events
                   if e.device_type == DeviceType.CUDA) / 1e3
        host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                      key=lambda e: e.self_cpu_time_total, reverse=True)
        kernels = sum(e.count for e in events
                      if e.device_type == DeviceType.CUDA)
        return dict(step_ms_median=ms[len(ms) // 2], step_ms_min=ms[0],
                    traced_wall_ms=wall * 1e3, device_busy_ms=busy,
                    device_kernels=kernels,
                    launches=ops.launch_counts(),
                    top_host_ops=[dict(name=e.key, calls=e.count,
                                       self_cpu_ms=e.self_cpu_time_total
                                       / 1e3) for e in host[:15]])
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gib", type=float, default=6.0)
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("train_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    print(json.dumps({"part": "checkpoint_io", **checkpoint_io(args.gib)}),
          flush=True)
    print(json.dumps({"part": "small_step", **small_step(args.steps)}),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
