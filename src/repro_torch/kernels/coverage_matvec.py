"""coverage_matvec: the C5 counter rebuild ``counter = alive @ R``.

Replaces the TPU kernel
``src/repro/kernels/coverage_matvec.py:coverage_matvec``.  ``alive`` is
a 0/1 row mask (bool or float) over a ``(theta, n)`` uint8 bitmap arena;
the count is exact in int32 and returned as float32 like the reference
(exact for theta < 2**24).

Bound on an H100: bytes — each alive row is read once: ``alive_rows *
n`` bytes (+ theta mask bytes + 4n output), 5.49 GB with every row alive
at theta = 16,384, n = 334,863 (about 1.6 ms at 3.35 TB/s).  Dead rows
are skipped, so later greedy rounds read less.  Design: one block per
512-column tile streams all rows with 16-byte loads, sums its warps in
shared memory and writes the tile once (``csrc/coverage_matvec.cu``,
``csrc/colcount.cuh``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _common as C
from repro_torch.kernels import build

KERNEL = "coverage_matvec"
#: rows per float32 chunk of the plain version (bounds its copy of R)
PLAIN_CHUNK = 2048


def coverage_matvec_plain(alive, R) -> torch.Tensor:
    """``alive.float() @ R.float()`` in row chunks; every partial sum is
    an integer below 2**24, so chunking changes no bit."""
    a = alive.to(torch.float32)
    out = torch.zeros(R.shape[1], dtype=torch.float32, device=R.device)
    for s in range(0, R.shape[0], PLAIN_CHUNK):
        out += a[s:s + PLAIN_CHUNK] @ R[s:s + PLAIN_CHUNK].to(torch.float32)
    return out


def alive_mask(alive: torch.Tensor, theta: int, kernel: str) -> torch.Tensor:
    """A contiguous uint8 0/1 mask of a bool/float ``alive``."""
    if tuple(alive.shape) != (theta,):
        raise ValueError(f"{kernel}: alive has shape {tuple(alive.shape)}, "
                         f"R has {theta} rows")
    mask = alive if alive.dtype == torch.bool else alive != 0
    return mask.contiguous().view(torch.uint8)


def coverage_matvec_cuda(alive, R) -> torch.Tensor:
    R = C.as_bytes(R)
    theta, n = R.shape
    out = torch.empty(n, dtype=torch.float32, device=R.device)
    if n == 0:
        return out
    mask = alive_mask(alive, theta, KERNEL)
    ptr, ld = C.row_view(R, f"{KERNEL} R")
    fn = C.bind(build.library("coverage_matvec"), "repro_coverage_matvec",
                (C.VOIDP, C.I64, C.VOIDP, C.I32, C.I32, C.VOIDP, C.VOIDP))
    with C.on_device(KERNEL, R, mask, out) as stream:
        err = fn(ptr, ld, mask.data_ptr(), theta, n, out.data_ptr(), stream)
    C.launched(KERNEL, err)
    return out
