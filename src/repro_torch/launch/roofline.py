"""Device peaks, per-kernel cost models and roofline terms
(``repro.launch.roofline``).

Three terms per program, in seconds::

    compute    = flops_per_device / peak_flops
    memory     = bytes_per_device / hbm_bytes_per_s
    collective = wire_bytes_per_device / link_bytes_per_s

`HW_PEAKS` holds the reference's rows (``tpu``: TPU v5e; ``gpu``: an
A100-40G class part; ``cpu``; a deliberately tiny ``unknown``) and an
``h100`` row: H100 SXM from NVIDIA's data sheet, the dense bf16
tensor-core rate, HBM3 bytes/s, NVLink bytes/s a direction and, beyond
the reference's keys, ``peak_flops_f32``, the float32 rate outside the
tensor cores (an FMA counts two operations) that bounds the port's f32
and integer kernels.  ``chip_smoke.py`` reads its bounds from that row.

The reference's HLO collective parser (``parse_collectives``) reads XLA
text; PyTorch eager lowers nothing, so the port counts its collectives as
they run instead (`repro_torch.launch.dryrun.collective_census`).
"""
from __future__ import annotations

import torch

#: the reference's TPU row (``repro.launch.mesh.TPU_V5E``), per chip
TPU_V5E = {
    "name": "TPU v5e",
    "peak_flops_bf16": 197e12,
    "hbm_bytes_per_s": 819e9,
    "ici_bytes_per_s": 50e9,
    "hbm_bytes": 16 * 2**30,
}

H100 = {
    "name": "H100 SXM",
    "peak_flops_bf16": 989e12,
    "peak_flops_f32": 67e12,
    "hbm_bytes_per_s": 3.35e12,
    "ici_bytes_per_s": 450e9,
    "hbm_bytes": 80 * 2**30,
}

HW_PEAKS = {
    "tpu": TPU_V5E,
    "h100": H100,
    "gpu": {
        "name": "A100-40G class",
        "peak_flops_bf16": 312e12,
        "hbm_bytes_per_s": 1.555e12,
        "ici_bytes_per_s": 300e9,
        "hbm_bytes": 40 * 2**30,
    },
    "cpu": {
        "name": "server CPU (estimate)",
        "peak_flops_bf16": 1e12,
        "hbm_bytes_per_s": 5e10,
        "ici_bytes_per_s": 1e10,
        "hbm_bytes": 64 * 2**30,
    },
    "unknown": {
        "name": "unknown device",
        "peak_flops_bf16": 1e9,
        "hbm_bytes_per_s": 1e9,
        "ici_bytes_per_s": 1e9,
        "hbm_bytes": 1 * 2**30,
    },
}


def peaks_for(device_kind: str | None = None) -> dict:
    """The `HW_PEAKS` row for a device kind; None reads this process's
    card: ``h100`` on an H100, ``gpu`` on any other CUDA card, else
    ``cpu``.  Anything unrecognized gets the ``unknown`` row."""
    if device_kind is None:
        if not torch.cuda.is_available():
            device_kind = "cpu"
        elif "H100" in torch.cuda.get_device_name():
            device_kind = "h100"
        else:
            device_kind = "gpu"
    return HW_PEAKS.get(str(device_kind), HW_PEAKS["unknown"])


# --------------------------------------------- per-kernel cost models ----
#
# Analytic (flops, bytes) of the useful work of each kernel of
# ``repro.kernels`` at the shapes each entry names: 2 flops a MAC, one
# memory touch a logical input and output byte.

KERNEL_COST_MODELS = {
    # masked counter rebuild: (theta,) x (theta, n) mat-vec
    "coverage_matvec": lambda theta, n: (
        2.0 * theta * n, theta * n + 4.0 * theta + 4.0 * n),
    # the same reduction fused with the argmax (outputs are scalars)
    "fused_select": lambda theta, n: (
        2.0 * theta * n + n, theta * n + 4.0 * theta),
    # one probabilistic-BFS step: frontier @ logq + activation test
    "ic_frontier_step": lambda B, n: (
        2.0 * B * n * n + 4.0 * B * n,
        4.0 * n * n + 3.0 * B * n),
    # encode + column count over one sampled batch: bitmap stores B*n
    # bytes back, packed B*n/8
    "arena_commit": lambda B, n, kind="bitmap": (
        (2.0 if kind == "packed" else 1.0) * B * n,
        B * n + (B * n / 8.0 if kind == "packed" else B * n) + 4.0 * n),
    # decode-and-count over a bit-packed arena
    "packed_count": lambda theta, n: (
        3.0 * theta * n, theta * n / 8.0 + 4.0 * theta + 4.0 * n),
    # decode-and-count over token rows (s_pad int32 tokens a row)
    "token_count": lambda theta, n, s_pad=8: (
        3.0 * theta * n, 4.0 * theta * s_pad + 4.0 * theta + 4.0 * n),
    # the fused sample -> write -> count chain: ``steps`` frontier
    # passes and the commit
    "sample_write_count": lambda B, n, steps=4, kind="bitmap": tuple(
        a + b for a, b in zip(
            tuple(x * steps for x in
                  KERNEL_COST_MODELS["ic_frontier_step"](B=B, n=n)),
            KERNEL_COST_MODELS["arena_commit"](B=B, n=n, kind=kind))),
}


def kernel_cost(kernel: str, **shape) -> tuple[float, float]:
    """(flops, bytes) of ``kernel`` at ``shape``; KeyError for a kernel
    with no model, so no caller reports a cost of zero."""
    return KERNEL_COST_MODELS[kernel](**shape)


def achieved_frac(kernel: str, wall_s: float, *,
                  device_kind: str | None = None, **shape) -> float:
    """The kernel's best-case time on ``device_kind`` (the larger of its
    compute and memory terms) over the measured ``wall_s``, clamped to
    [0, 1]."""
    if wall_s <= 0.0:
        return 0.0
    flops, bytes_acc = kernel_cost(kernel, **shape)
    hw = peaks_for(device_kind)
    t_bound = max(flops / hw["peak_flops_bf16"],
                  bytes_acc / hw["hbm_bytes_per_s"])
    return min(t_bound / wall_s, 1.0)


def roofline_terms(flops: float, bytes_acc: float, wire_bytes: float,
                   model_flops_global: float, n_devices: int,
                   hw: dict = TPU_V5E, extra: dict | None = None) -> dict:
    """Roofline terms of one program; every input is per device except
    ``model_flops_global``, the whole step's analytic count."""
    t_compute = flops / hw["peak_flops_bf16"]
    t_memory = bytes_acc / hw["hbm_bytes_per_s"]
    t_collective = wire_bytes / hw["ici_bytes_per_s"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dominant = max(terms, key=terms.get)
    hlo_flops_global = flops * n_devices
    return {
        **terms,
        "dominant": dominant,
        "bound_s": terms[dominant],
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_acc,
        "wire_bytes_per_device": wire_bytes,
        "model_flops_global": model_flops_global,
        "useful_flops_ratio": (model_flops_global / hlo_flops_global
                               if hlo_flops_global else 0.0),
        "roofline_fraction": (
            (model_flops_global / n_devices / hw["peak_flops_bf16"])
            / terms[dominant] if terms[dominant] > 0 else 0.0),
        **(extra or {}),
    }
