#!/usr/bin/env python3
"""Probe the arena_commit kernel on one NVIDIA GPU: the copy form it
uses against a ring of bulk copies, and what the arena's row stride
costs it.

    python3 scripts/commit_probe.py           # from the root of a checkout

Every case commits chip_smoke.py's main batch (B 256 x n 334,863, rows
shaped like the sampler's) into rows [300, 556) of a 1,024-row arena,
with sizes, and holds arena, counter and sizes bitwise against the plain
version first.  Prints one JSON line each:

  ring    eager and CUDA-graph ms of csrc/commit.cu (registers: 8
          independent 16-byte loads a thread) and of scripts/commit_ring.cu
          (the same counting fed from a 2-stage ring of 32-row stages in
          shared memory, filled by cp.async.bulk from one producer
          thread), both kinds
  stride  the bitmap kernel with the store's 16-byte row strides
          (334,864 bytes: every other arena row starts 16 bytes into a
          32-byte sector) and with 128-byte strides (334,976), in and out
  copy    torch's copy of the same rows: the padded rows as one
          contiguous block (a device-to-device memcpy) and the
          (B, n) views (a strided elementwise copy, the plain version's)
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

LO, CAP = 300, 1024


def build_ring(build) -> ctypes.CDLL:
    tmp = tempfile.mkdtemp(dir=build.BUILD_DIR)
    so = os.path.join(tmp, "libcommit_ring.so")
    proc = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         so, os.path.join(ROOT, "scripts", "commit_ring.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on commit_ring.cu:\n{proc.stdout}"
                           f"{proc.stderr}")
    print(proc.stdout + proc.stderr, file=sys.stderr)
    return ctypes.CDLL(so)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("commit_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _common as C
    from repro_torch.kernels import build, commit, ops

    build.build_all()
    power = cs.nvidia_smi()
    argtypes = (C.VOIDP, C.I64, C.VOIDP, C.I64, C.VOIDP, C.VOIDP, C.I32,
                C.I32, C.VOIDP)
    libs = {"kernel": build.library("commit"), "ring": build_ring(build)}
    symbols = {"kernel": "repro_commit_{}", "ring": "repro_commit_ring_{}"}
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, n = cs.BATCH, cs.AMAZON_N
    buf, rows = cs.bitmap_arena(torch, B, n, gen, ld=ops.padded_width(n))

    def case(kind, lib, sym, src, ld_arena):
        """A call of ``sym`` committing ``src`` into an arena of row
        stride ``ld_arena``, checked once against the plain version."""
        w = n if kind == "bitmap" else -(-n // 8)
        arena = torch.zeros((CAP, ld_arena), dtype=torch.uint8,
                            device="cuda")
        cnt = torch.zeros(n, dtype=torch.int32, device="cuda")
        sizes = torch.full((CAP,), 7, dtype=torch.int32, device="cuda")
        want = [t.clone() for t in (arena, cnt, sizes)]
        plain = (commit.arena_commit_plain if kind == "bitmap"
                 else commit.arena_commit_packed_plain)
        plain(src, want[0][LO:LO + B, :w], want[1], want[2][LO:LO + B])
        fn = C.bind(lib, sym.format(kind), argtypes)
        out, sz = arena[LO:LO + B, :w], sizes[LO:LO + B]

        def call():
            with C.on_device(sym, src, out) as stream:
                err = fn(src.data_ptr(), src.stride(0), out.data_ptr(),
                         out.stride(0), cnt.data_ptr(), sz.data_ptr(), B, n,
                         stream)
            cs.check(err == 0, f"{sym.format(kind)}: launch error {err}")

        call()
        torch.cuda.synchronize()
        for got, ref, what in zip((arena, cnt, sizes), want,
                                  ("arena", "counter", "sizes")):
            cs.check(torch.equal(got, ref), f"{sym.format(kind)} {what}")
        return call

    def times(call):
        return dict(ms=cs.time_cuda(torch, call, iters=20),
                    graph_ms=cs.time_graph(torch, call))

    ring = {}
    for kind in ("bitmap", "packed"):
        ld_arena = ops.padded_width(n if kind == "bitmap" else -(-n // 8))
        for name, lib in libs.items():
            ring[f"{kind}/{name}"] = times(
                case(kind, lib, symbols[name], rows, ld_arena))
    cs.emit("ring", power=power, shape=[B, n], **ring)

    ld128 = -(-n // 128) * 128
    buf128 = torch.zeros((B, ld128), dtype=torch.uint8, device="cuda")
    buf128[:, :n] = rows
    stride = {
        "16": times(case("bitmap", libs["kernel"], symbols["kernel"], rows,
                         ops.padded_width(n))),
        "128": times(case("bitmap", libs["kernel"], symbols["kernel"],
                          buf128[:, :n], ld128))}
    cs.emit("stride", power=power, shape=[B, n], row_stride_bytes={
        "16": ops.padded_width(n), "128": ld128}, **stride)
    del buf128

    arena = torch.zeros((CAP, ops.padded_width(n)), dtype=torch.uint8,
                        device="cuda")
    block, view = arena[LO:LO + B], arena[LO:LO + B, :n]
    cs.emit("copy", power=power, shape=[B, n],
            memcpy=times(lambda: block.copy_(buf)),
            strided=times(lambda: view.copy_(rows)))
    print(power, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
