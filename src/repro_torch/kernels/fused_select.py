"""fused_select: one greedy round's ``(max, argmax)`` of ``alive @ R``
with the counter kept out of device memory.

Replaces the TPU kernel ``src/repro/kernels/fused_select.py:fused_select``.
Ties go to the smallest column (``jnp.argmax``'s first maximum), so an
all-zero ``alive`` answers ``(0.0, 0)``; columns past ``n`` never win.

Bound on an H100: bytes, as `coverage_matvec` — ``alive_rows * n`` bytes
read.  Design: a block owns a 512-column tile and loops over all theta
rows, reducing the tile to one (count, first column) pair in registers
and shared memory; a second one-block launch picks the winner across
tiles (``csrc/fused_select.cu``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _common as C
from repro_torch.kernels import build
from repro_torch.kernels.coverage_matvec import (
    alive_mask, coverage_matvec_plain,
)

KERNEL = "fused_select"
TILE_COLS = 512     # kTileCols of csrc/colcount.cuh


def fused_select_plain(alive, R):
    """``(counter.max(), counter.argmax())`` with the plain counter."""
    counter = coverage_matvec_plain(alive, R)
    return counter.max(), torch.argmax(counter).to(torch.int32)


def fused_select_cuda(alive, R):
    R = C.as_bytes(R)
    theta, n = R.shape
    if n == 0:
        raise ValueError(f"{KERNEL}: argmax of an empty counter")
    mask = alive_mask(alive, theta, KERNEL)
    ptr, ld = C.row_view(R, f"{KERNEL} R")
    tiles = -(-n // TILE_COLS)
    scratch = torch.empty((2, tiles), dtype=torch.int32, device=R.device)
    best = torch.empty((), dtype=torch.float32, device=R.device)
    idx = torch.empty((), dtype=torch.int32, device=R.device)
    fn = C.bind(build.library("fused_select"), "repro_fused_select",
                (C.VOIDP, C.I64, C.VOIDP, C.I32, C.I32, C.VOIDP, C.VOIDP,
                 C.VOIDP, C.VOIDP, C.VOIDP))
    with C.on_device(KERNEL, R, mask, idx) as stream:
        err = fn(ptr, ld, mask.data_ptr(), theta, n, scratch[0].data_ptr(),
                 scratch[1].data_ptr(), best.data_ptr(), idx.data_ptr(),
                 stream)
    C.launched(KERNEL, err)
    return best, idx
