#!/usr/bin/env python3
"""Probe the decode-and-count kernels on one NVIDIA GPU: what sets
token_count's pace, and whether its time shows in a selection.

    python3 scripts/count_probe.py            # from the root of a checkout

Prints one JSON line each:

  groups    token_count at the kernel rows' arena of chip_smoke.py
            (theta 16,384 x n 334,863, s_pad 65,536) built with
            kGroups = 1, 2, 4, 8 span groups (csrc/token_count.cu uses 2)
  ablate    the same arena with parts of csrc/token_count.cu switched off
            at build time (results then wrong, only timed): the scatter
            into the stage, the carry-save counting, the atomics of the
            flush, and all three
  select    one 50-seed fused-rebuild selection on the compressed store
            of the full com-Amazon solve (chip_smoke.py's
            compressed_full) under torch.profiler: traced wall, device
            busy time and the kernels that take it
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

GROUPS = "constexpr int kGroups = 2;"
#: statements of csrc/token_count.cu that an ablation leaves out
ABLATE = {
    "scatter": "sb[(tok >> kShift) - b0] = (uint8_t)(tok & 0xFF);",
    "count": "repro_torch::add8(P, x);",
    "flush": "if (v && col < n) atomicAdd(out + col, v);",
}


def build_variants(build) -> dict:
    """csrc/token_count.cu built once per variant, in parallel: with
    kGroups = 1, 4 and 8 (``g1``, ...) and with each ablated statement
    commented out (and all three: ``all``)."""
    src = (build.CSRC / "token_count.cu").read_text()
    for stmt in (GROUPS, *ABLATE.values()):
        if src.count(stmt) != 1:
            raise RuntimeError(f"token_count.cu: no single {stmt!r}")
    edits = {f"g{g}": [(GROUPS, GROUPS.replace("2", str(g)))]
             for g in (1, 4, 8)}
    edits.update({k: [(v, f"/* {v} */")] for k, v in ABLATE.items()})
    edits["all"] = [(v, f"/* {v} */") for v in ABLATE.values()]
    tmp = tempfile.mkdtemp(dir=build.BUILD_DIR)
    procs = {}
    for name, subs in edits.items():
        text = src
        for old, new in subs:
            text = text.replace(old, new)
        cu = os.path.join(tmp, f"token_count_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(tmp, f"lib_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", so, cu], stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant")
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("count_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _common as C
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import coverage_matvec as cov
    from repro_torch.kernels import packed_count as pcm

    build.build_all()
    cs.load_peaks()
    power = cs.nvidia_smi()
    argtypes = (C.VOIDP, C.I64, C.VOIDP, C.I32, C.I32, C.I32, C.VOIDP,
                C.VOIDP, C.VOIDP)

    def token_count(lib, T, mask, n):
        fn = C.bind(lib, "repro_token_count", argtypes)
        out = torch.zeros(n, dtype=torch.int32, device="cuda")
        runs = torch.zeros(-(-n // 256), dtype=torch.int32, device="cuda")
        with C.on_device("token_count", T, mask, out) as stream:
            err = fn(T.data_ptr(), T.stride(0), mask.data_ptr(), T.shape[0],
                     T.shape[1], n, out.data_ptr(), runs.data_ptr(), stream)
        if err != 0:
            raise RuntimeError("token_count launch failed")
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    theta, n = cs.THETA, cs.AMAZON_N
    buf, R = cs.bitmap_arena(torch, theta, n, gen, ld=ops.padded_width(n))
    R[5::64] = 1
    R[37::64, 2560:2560 + 256 * 40] = 1
    _, T, need = cs.encode_arena(torch, R)
    del buf, R
    full = torch.ones(theta, dtype=torch.bool, device="cuda")
    mask = cov.alive_mask(full, theta, "probe")
    libs = {"g2": build.library("token_count"), **build_variants(build)}
    want = pcm.token_count_plain(T, full, n)
    bound_ms = cs.bound(4 * int(need.sum()) + theta + 4 * n)[0]
    ms = {}
    for name, lib in libs.items():
        if name.startswith("g"):
            cs.check(torch.equal(token_count(lib, T, mask, n), want),
                     f"token_count built with {name}")
        ms[name] = cs.time_cuda(torch, lambda: token_count(lib, T, mask, n))
    cs.emit("groups", power=power, bound_ms=bound_ms,
            ms={k[1:]: v for k, v in ms.items() if k.startswith("g")})
    cs.emit("ablate", power=power, bound_ms=bound_ms,
            ms={"none": ms["g2"], **{k: v for k, v in ms.items()
                                     if not k.startswith("g")}})
    del T, need
    torch.cuda.empty_cache()

    from repro_torch.core.engine import IMMConfig, InfluenceEngine
    from repro_torch.graphs.datasets import synthetic_snap
    cfg = IMMConfig(k=50, eps=0.5, model="IC", max_theta=cs.THETA,
                    selection_method="rebuild", seed=0, store="compressed")
    engine = InfluenceEngine(synthetic_snap("com-Amazon", seed=0), cfg,
                             device="cuda")
    engine.run()

    def select():
        engine._select_cache.clear()
        engine.select(50, method="fused-rebuild")

    ops.reset_launches()
    wall, busy, kernels = cs.trace_device(torch, [select, select])
    cs.emit("select", power=power, store="compressed", theta=engine.theta,
            s_pad=engine.store.codec.s_pad, traced_wall_s=wall,
            device_busy_s=busy, launches=ops.launch_counts(),
            kernels=kernels)
    print(power, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
