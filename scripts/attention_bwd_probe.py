#!/usr/bin/env python3
"""Time the attention kernels on the card, alone: the backward, or with
``--forward`` the f32 forward, or with ``--forward-tc`` the bf16 forward.

    python3 scripts/attention_bwd_probe.py [--repeats 3] [--yardsticks]
        [--kernels] [--root DIR]
    python3 scripts/attention_bwd_probe.py --forward [--repeats 3]
        [--root DIR]
    python3 scripts/attention_bwd_probe.py --f32-backward [--repeats 3]
        [--root DIR]
    python3 scripts/attention_bwd_probe.py --forward-tc [--repeats 3]
        [--root DIR]

Builds the port's kernels from ``DIR/src`` (default: this checkout; the
helpers and shapes come from this checkout's ``chip_smoke.py``) and
prints one JSON line with the card's name and power limit.  Run it from
two checkouts in one call to compare two versions on one card: ``--root``
each in turn, in the order parent, change, change, parent.

The backward (the default): times ``flash_attention_backward_cuda``
(CUDA events, the mean of 20 calls after 3 warm-ups, ``--repeats``
times) at ``chip_smoke.py``'s backward shapes, ``ATTN_BWD_TRAIN``
(Qwen1.5-0.5B's training shape) and ``ATTN_BWD_SHAPES`` (grok-1's heads,
h2o-danube-3's with its window, qwen-100m's in f32), beside each shape's
bound from ``attention_bwd_bound`` (the gradient's 10 D flops an admitted
pair at the roofline's h100 rate for the dtype); with ``--yardsticks``,
each repeat also times ``attention_bwd_yardsticks`` there (the plain
backward and SDPA's backward alone); with ``--kernels``, the device ms of
each kernel and memset of one call (the mean of 5 under
``torch.profiler``), by name.

``--forward``: builds the f32 forward's source alone and times
``flash_attention_cuda`` in f32 (the SIMT kernel; the mean of 20 calls
after 3 warm-ups, ``--repeats`` times) at ``chip_smoke.py``'s
``ATTN_F32_TIMED`` shapes and Danube's windowed one (``danube_8k`` of
``ATTN_TIMED``), each repeat beside SDPA in f32 on the same inputs, with
the bound at the f32 rate (`attention_bound`) and the share of it the
kernel reaches; then the kernel's and SDPA's device ms alone (the mean
of 5 calls under ``torch.profiler``, as ``--kernels``), which at the
small shapes is below the calls' enqueue time.  Each shape's output is held to the
plain version (``ATTN_TOL``), compared bitwise with a second call, and
the plain version timed once (the mean of 2 calls after 1).
Where the build has ``repro_flash_attention_config``, each shape also
gets its tile: query rows a block, shared memory, registers and local
(stack and spill) bytes a thread, blocks an SM; and ptxas's register
and spill lines of the build, either way.

``--f32-backward``: builds the f32 forward's and backward's sources
alone and times ``flash_attention_backward_cuda`` in f32 (the SIMT
kernels, from the forward's logsumexp and, where the checkout's wrapper
takes it, its output; the mean of 20 calls after a warm-up, 5 at S
above 2,048, ``--repeats`` times) at ``chip_smoke.py``'s
``ATTN_BWD_F32_TIMED``, each repeat beside SDPA's f32 backward alone on
the same inputs; the bound at the gradient's 10 D flops a pair and at
the design's (`attention_bwd_bound`), the share of the 10 D bound; the
device ms of each pass and of SDPA's backward under the profiler; dq,
dk, dv held to the plain backward (``ATTN_TOL``), two calls bitwise,
the plain backward timed once; each pass's tile from
``repro_flash_attention_bwd_config`` where the build has it, and
ptxas's lines.  At qwen-100m's shape it also takes the host µs of one
Python call of each direction (the mean of 200 enqueued without a
sync) and of binding the backward's C entry point (`_common.bind`).

``--forward-tc``: builds the bf16 forward's source alone and times
``flash_attention_cuda`` in bf16 (the tensor-core kernel; the mean of 20
calls after 3 warm-ups, ``--repeats`` times) at ``chip_smoke.py``'s
``ATTN_TIMED`` shapes (the serving prefill, Qwen's 8k prefill, Danube's
window, prefill_32k, Qwen1.5-0.5B's training shape) and grok-1's heads
(``ATTN_BWD_SHAPES``: 1 x 48:8 x 2,048 x 128), each repeat beside
SDPA on the same inputs (`chip_smoke.sdpa`), with the bound at the bf16
tensor-core rate (`attention_bound`) and the share of it the kernel
reaches; then the kernel's and SDPA's device ms alone (the mean of 5
calls under the profiler).  Each shape's output is held to the plain
version (``ATTN_TOL``) and its logsumexp to the plain version's
(``ATTN_LSE_TOL``), output and logsumexp compared bitwise with a second
call (`chip_smoke.attention_repeat`).  Where the build has ``repro_flash_attention_tc_config``,
the tile: query rows a block, shared memory, registers a thread at launch
and a consumer's after ``setmaxnreg``, local (stack and spill) bytes a
thread, blocks an SM, keys a tile and ring stages; and ptxas's lines of
the build, either way.
"""
from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_ms(torch, call, n: int) -> dict:
    """Device ms a call of each kernel (and memset) that ``call``
    launches, the mean over ``n`` calls under the profiler, keyed by the
    kernel's name up to its template arguments."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    ms: dict = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = ev.name.replace("void ", "").replace(
            "(anonymous namespace)::", "").split("<")[0].split("(")[0]
        ms[key] = ms.get(key, 0.0) + ev.device_time / 1e3 / n
    return ms


def event_ms(torch, call, warmup: int = 3, iters: int = 20) -> float:
    """The mean ms of ``iters`` calls after ``warmup``, CUDA events."""
    for _ in range(warmup):
        call()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        call()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def backward(torch, args, chip_smoke, fa, gen, out) -> None:
    for name, B, Hq, Hkv, S, D, window, dtype in (
            (chip_smoke.ATTN_BWD_TRAIN,) + chip_smoke.ATTN_BWD_SHAPES):
        def draw(h):
            return torch.randn((B, h, S, D), generator=gen,
                               device="cuda").to(getattr(torch, dtype))

        q, k, v, dout = draw(Hq), draw(Hkv), draw(Hkv), draw(Hq)
        o, lse = fa.forward_cuda(q, k, v, window=window, with_lse=True)
        # an f32 backward that takes delta from the forward's output
        extra = {"out": o} if dtype == "float32" and "out" in \
            inspect.signature(fa.flash_attention_backward_cuda).parameters \
            else {}

        def call():
            return fa.flash_attention_backward_cuda(q, k, v, lse, dout,
                                                    window=window, **extra)

        runs, yardsticks = [], []
        for _ in range(args.repeats):
            if args.yardsticks:
                yardsticks.append(chip_smoke.attention_bwd_yardsticks(
                    torch, q, k, v, dout, window))
            runs.append(event_ms(torch, call))
        bound_ms, _, design_ms, _ = chip_smoke.attention_bwd_bound(
            B, Hq, Hkv, S, D, window, f32=dtype == "float32")
        out[name] = dict(shape=[B, Hq, Hkv, S, D], window=window,
                         dtype=dtype, ms=runs, bound_ms=bound_ms,
                         design_bound_ms=design_ms)
        if yardsticks:
            out[name].update(plain_ms=[y[0] for y in yardsticks],
                             library_ms=[y[1] for y in yardsticks])
        if args.kernels:
            out[name]["kernel_ms"] = kernel_ms(torch, call, 5)
        del q, k, v, dout, lse, o, extra
        torch.cuda.empty_cache()


def forward_tile(lib, S: int, D: int) -> dict | None:
    """What the build says a launch at (S, D) runs, where it can say."""
    try:
        fn = lib.repro_flash_attention_config
    except AttributeError:
        return None
    info = (ctypes.c_int * 5)()
    fn.argtypes = (ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
    if fn(S, D, ctypes.addressof(info)) != 0:
        return None
    return dict(zip(("rows", "smem_bytes", "registers", "local_bytes",
                     "blocks_per_sm"), info))


def forward(torch, args, chip_smoke, fa, gen, out) -> None:
    from repro_torch.kernels import build

    # the f32 forward's library alone: the other sources are not timed
    build.build_all(("flash_attention",))
    lib = ctypes.CDLL(str(build.lib_path("flash_attention")))
    build._libs.setdefault("flash_attention", lib)
    out["ptxas"] = ptxas_lines(build, "flash_attention")
    shapes = chip_smoke.ATTN_F32_TIMED + tuple(
        row for row in chip_smoke.ATTN_TIMED if row[0] == "danube_8k")
    for name, B, Hq, Hkv, S, D, window in shapes:
        q, k, v = chip_smoke.attention_inputs(torch, gen, B, Hq, Hkv, S, S,
                                              D, torch.float32)

        def call():
            return fa.flash_attention_cuda(q, k, v, window=window)

        got = call()
        abs_e, rel_e = chip_smoke.attention_err(
            torch, got, fa.flash_attention_plain(q, k, v, window=window),
            "float32", f"{name} f32")
        bitwise = bool(torch.equal(got, call()))
        del got
        plain_ms = event_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, window=window), warmup=1, iters=2)
        lib_call = chip_smoke.sdpa(torch, q, k, v, window)
        runs, sdpa_runs = [], []
        for _ in range(args.repeats):
            sdpa_runs.append(event_ms(torch, lib_call))
            runs.append(event_ms(torch, call))
        _, _, bound_ms, _ = chip_smoke.attention_bound(
            B, Hq, Hkv, S, S, D, window, f32=True)
        out[name] = dict(shape=[B, Hq, Hkv, S, D], window=window, ms=runs,
                         device_ms=kernel_ms(torch, call, 5),
                         sdpa_ms=sdpa_runs,
                         sdpa_device_ms=kernel_ms(torch, lib_call, 5),
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_share=[bound_ms / ms for ms in runs],
                         max_abs_err=abs_e, max_rel_err=rel_e,
                         bitwise_twice=bitwise,
                         tile=forward_tile(lib, S, D))
        del q, k, v, lib_call
        torch.cuda.empty_cache()


def ptxas_lines(build, name: str) -> list:
    """ptxas's register, spill and entry lines of a build, and any warning
    that it serialized the wgmmas or ignored setmaxnreg."""
    log = build.BUILD_DIR / f"{name}.log"
    if not log.exists():
        return []
    keys = ("registers", "spill", "Compiling entry", "Performance Loss",
            "setmaxnreg", "wgmma")
    return [line.strip() for line in log.read_text().splitlines()
            if any(key in line for key in keys)]


#: the fields of ``repro_flash_attention_tc_config``
TC_TILE_KEYS = ("rows", "smem_bytes", "registers", "local_bytes",
                "blocks_per_sm", "consumer_registers", "producer_registers",
                "tile_keys", "stages")


def tc_tile(lib, D: int) -> dict | None:
    """What the build says the bf16 forward runs at head dim D, where it
    can say."""
    try:
        fn = lib.repro_flash_attention_tc_config
    except AttributeError:
        return None
    info = (ctypes.c_int * len(TC_TILE_KEYS))()
    fn.argtypes = (ctypes.c_int, ctypes.c_void_p)
    if fn(D, ctypes.addressof(info)) != 0:
        return None
    return dict(zip(TC_TILE_KEYS, info))


def forward_tc(torch, args, chip_smoke, fa, gen, out) -> None:
    from repro_torch.kernels import build

    # the bf16 forward's library alone: the other sources are not timed
    build.build_all(("flash_attention_tc",))
    lib = ctypes.CDLL(str(build.lib_path("flash_attention_tc")))
    build._libs.setdefault("flash_attention_tc", lib)
    out["ptxas"] = ptxas_lines(build, "flash_attention_tc")
    shapes = chip_smoke.ATTN_TIMED + tuple(
        (f"{name}_heads", B, Hq, Hkv, S, D, window)
        for name, B, Hq, Hkv, S, D, window, _ in chip_smoke.ATTN_BWD_SHAPES
        if name == "grok")
    for name, B, Hq, Hkv, S, D, window in shapes:
        q, k, v = chip_smoke.attention_inputs(torch, gen, B, Hq, Hkv, S, S,
                                              D, torch.bfloat16)

        def call():
            return fa.flash_attention_cuda(q, k, v, window=window)

        abs_e, rel_e = chip_smoke.attention_err(
            torch, call(), fa.flash_attention_plain(q, k, v, window=window),
            "bfloat16", f"{name} bf16")
        # raises unless two calls are bitwise equal, output and lse
        lse_err = chip_smoke.attention_repeat(torch, q, k, v, True, window,
                                              f"{name} bf16")
        lib_call = chip_smoke.sdpa(torch, q, k, v, window)
        runs, sdpa_runs = [], []
        for _ in range(args.repeats):
            sdpa_runs.append(event_ms(torch, lib_call))
            runs.append(event_ms(torch, call))
        _, _, bound_ms, _ = chip_smoke.attention_bound(
            B, Hq, Hkv, S, S, D, window)
        out[name] = dict(shape=[B, Hq, Hkv, S, D], window=window, ms=runs,
                         kernel_ms=kernel_ms(torch, call, 5),
                         sdpa_ms=sdpa_runs,
                         sdpa_device_ms=sum(
                             kernel_ms(torch, lib_call, 5).values()),
                         bound_ms=bound_ms,
                         bound_share=[bound_ms / ms for ms in runs],
                         vs_sdpa=[ms / lib for ms, lib in
                                  zip(runs, sdpa_runs)],
                         max_abs_err=abs_e, max_rel_err=rel_e,
                         lse_err=lse_err, bitwise_twice=True,
                         tile=tc_tile(lib, D))
        del q, k, v, lib_call
        torch.cuda.empty_cache()


def backward_tiles(lib, D: int) -> dict | None:
    """What the build says each backward pass runs at head dim D, where
    it can say: own rows a block, walked rows a tile, shared memory,
    registers and local bytes a thread, blocks an SM, threads a block."""
    try:
        fn = lib.repro_flash_attention_bwd_config
    except AttributeError:
        return None
    keys = ("rows", "walked", "smem_bytes", "registers", "local_bytes",
            "blocks_per_sm", "threads")
    tiles = {}
    for npass, name in enumerate(("dq", "dkdv")):
        info = (ctypes.c_int * 7)()
        fn.argtypes = (ctypes.c_int,) * 2 + (ctypes.c_void_p,)
        if fn(D, npass, ctypes.addressof(info)) != 0:
            return None
        tiles[name] = dict(zip(keys, info))
    return tiles


def host_us(torch, call, n: int = 200) -> float:
    """Host µs of one Python call, ``n`` enqueued with no sync between."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def f32_backward(torch, args, chip_smoke, fa, gen, out) -> None:
    from repro_torch.kernels import _common as C
    from repro_torch.kernels import build

    names = ("flash_attention", "flash_attention_bwd")
    build.build_all(names)
    for name in names:
        build._libs.setdefault(name, ctypes.CDLL(str(build.lib_path(name))))
    lib = build._libs["flash_attention_bwd"]
    out["ptxas"] = ptxas_lines(build, "flash_attention_bwd")
    takes_out = "out" in inspect.signature(
        fa.flash_attention_backward_cuda).parameters
    out["takes_out"] = takes_out
    for name, B, Hq, Hkv, S, D, window in chip_smoke.ATTN_BWD_F32_TIMED:
        big = S > 2048
        q, k, v = chip_smoke.attention_inputs(torch, gen, B, Hq, Hkv, S, S,
                                              D, torch.float32)
        dout = torch.randn(q.shape, generator=gen, device="cuda")
        o, lse = fa.forward_cuda(q, k, v, window=window, with_lse=True)
        extra = {"out": o} if takes_out else {}

        def call():
            return fa.flash_attention_backward_cuda(q, k, v, lse, dout,
                                                    window=window, **extra)

        got = call()
        want = fa.flash_attention_backward_plain(q, k, v, dout,
                                                 window=window)
        errs = {g_name: chip_smoke.attention_err(
            torch, g, w, "float32", f"{name} backward {g_name}")
            for g_name, g, w in zip(("dq", "dk", "dv"), got, want)}
        bitwise = all(bool(torch.equal(a, b)) for a, b in zip(got, call()))
        del got, want
        plain_ms = event_ms(torch, lambda: fa.flash_attention_backward_plain(
            q, k, v, dout, window=window), warmup=1, iters=1)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        o_lib = chip_smoke.sdpa(torch, qg, kg, vg, window)()

        def lib_call():
            return torch.autograd.grad(o_lib, (qg, kg, vg), dout,
                                       retain_graph=True)

        iters = 5 if big else 20
        runs, sdpa_runs = [], []
        for _ in range(args.repeats):
            sdpa_runs.append(event_ms(torch, lib_call, warmup=1,
                                      iters=iters))
            runs.append(event_ms(torch, call, warmup=1, iters=iters))
        b_ms, by, design_ms, nbytes = chip_smoke.attention_bwd_bound(
            B, Hq, Hkv, S, D, window, f32=True)
        n_prof = 2 if big else 5
        out[name] = dict(
            shape=[B, Hq, Hkv, S, D], window=window, ms=runs,
            kernel_ms=kernel_ms(torch, call, n_prof),
            sdpa_ms=sdpa_runs, sdpa_device_ms=sum(
                kernel_ms(torch, lib_call, n_prof).values()),
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
            design_bound_ms=design_ms, bytes=nbytes,
            bound_share=[b_ms / ms for ms in runs],
            max_abs_err={n: e[0] for n, e in errs.items()},
            rel_err={n: e[1] for n, e in errs.items()},
            bitwise_twice=bitwise, tile=backward_tiles(lib, D))
        if name == "qwen_100m":
            argtypes = ((C.VOIDP,) * (10 if takes_out else 9)
                        + (C.I32,) * 8 + (ctypes.c_float, C.VOIDP))
            n = 2000
            t0 = time.perf_counter()
            for _ in range(n):
                C.bind(lib, "repro_flash_attention_bwd", argtypes)
            bind_us = (time.perf_counter() - t0) / n * 1e6
            out[name]["host_us"] = dict(
                forward=host_us(torch, lambda: fa.forward_cuda(
                    q, k, v, window=window, with_lse=True)),
                backward=host_us(torch, call), bind=bind_us)
        del q, k, v, dout, o, lse, qg, kg, vg, o_lib
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--f32-backward", action="store_true")
    ap.add_argument("--forward-tc", action="store_true")
    ap.add_argument("--yardsticks", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("attention_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(args.root, "src"), HERE]
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa

    chip_smoke.load_peaks()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    mode = ("forward" if args.forward else
            "f32_backward" if args.f32_backward else
            "forward_tc" if args.forward_tc else "backward")
    out = {"root": args.root, "nvidia_smi": smi, "mode": mode}
    {"forward": forward, "f32_backward": f32_backward,
     "forward_tc": forward_tc, "backward": backward}[mode](
        torch, args, chip_smoke, fa, gen, out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
