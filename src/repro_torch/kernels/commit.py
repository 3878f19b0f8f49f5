"""arena_commit (bitmap): write a sampled batch into the arena and add
its column sums to the fused counter, in one pass.

Replaces the TPU kernel ``src/repro/kernels/commit.py:arena_commit``
(``kind="bitmap"``, ``_bitmap_kernel``), which returns ``(stored,
colsum)`` for a separate ``_commit_write`` to copy into the arena.  Here
the kernel stores the batch straight into ``R[count:count + B]`` and
adds ``colsum`` into ``store.counter`` in place.

Bound on an H100: bytes — the batch is read once and written once, plus
the ``(n,)`` int32 counter: ``2 * B * n + 8 * n`` bytes (171 MB at
B = 256, n = 334,863, about 51 µs at 3.35 TB/s).  Design: 16-byte loads
and stores along n, column counts in byte lanes, one integer atomic per
nonzero column per 64-row block (``csrc/commit.cu``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _common as C
from repro_torch.kernels import build

KERNEL = "arena_commit"


def arena_commit_plain(rows, out, counter) -> None:
    """``out[...] = rows; counter += rows.sum(0)`` (int32)."""
    out.copy_(rows)
    counter += rows.sum(dim=0, dtype=torch.int32)


def arena_commit_cuda(rows, out, counter) -> None:
    rows, out = C.as_bytes(rows), C.as_bytes(out)
    B, n = rows.shape
    if tuple(out.shape) != (B, n) or tuple(counter.shape) != (n,):
        raise ValueError(f"{KERNEL}: rows {tuple(rows.shape)}, out "
                         f"{tuple(out.shape)}, counter {tuple(counter.shape)}")
    if counter.dtype != torch.int32 or not counter.is_contiguous():
        raise TypeError(f"{KERNEL}: counter must be contiguous int32")
    if B == 0 or n == 0:
        return
    p_in, ld_in = C.row_view(rows, f"{KERNEL} rows")
    p_out, ld_out = C.row_view(out, f"{KERNEL} out")
    fn = C.bind(build.library("commit"), "repro_commit_bitmap",
                (C.VOIDP, C.I64, C.VOIDP, C.I64, C.VOIDP, C.I32, C.I32,
                 C.VOIDP))
    err = fn(p_in, ld_in, p_out, ld_out, counter.data_ptr(), B, n, C.stream())
    C.launched(KERNEL, err)
