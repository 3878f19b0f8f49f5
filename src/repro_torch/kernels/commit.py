"""arena_commit: write a sampled batch into the arena in its at-rest form
and add its column sums to the fused counter, in one pass.

Replaces the TPU kernel ``src/repro/kernels/commit.py:arena_commit``
(``_bitmap_kernel`` for ``kind="bitmap"``, ``_packed_kernel`` for
``kind="packed"``), which returns ``(stored, colsum)`` for a separate
``_commit_write`` to copy into the arena.  Here the kernel stores the
batch straight into ``R[count:count + B]`` and adds ``colsum`` into
``store.counter`` in place.  The packed kind packs LSB-first, bitwise
`repro_torch.core.pack.codec.pack_bits`.

Bound on an H100: bytes — the batch is read once and its at-rest block
written once, plus the ``(n,)`` int32 counter: ``2 * B * n + 8 * n``
bytes for the bitmap kind (171 MB at B = 256, n = 334,863, about 51 µs
at 3.35 TB/s), ``B * n + B * ceil(n / 8) + 8 * n`` for the packed kind
(99 MB, about 30 µs).  Design: 16-byte loads along n, a 16-byte store
(bitmap) or a 2-byte store of four multiply-packed nibbles (packed) per
load, column counts in byte lanes, one integer atomic per nonzero column
per 64-row block (``csrc/commit.cu``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _common as C
from repro_torch.kernels import build

KERNEL = "arena_commit"
KERNEL_PACKED = "arena_commit_packed"


def arena_commit_plain(rows, out, counter) -> None:
    """``out[...] = rows; counter += rows.sum(0)`` (int32)."""
    out.copy_(rows)
    counter += rows.sum(dim=0, dtype=torch.int32)


def arena_commit_packed_plain(rows, out, counter) -> None:
    """``out[...] = pack_bits(rows); counter += rows.sum(0)`` (int32)."""
    from repro_torch.core.pack.codec import pack_bits
    out.copy_(pack_bits(rows))
    counter += rows.sum(dim=0, dtype=torch.int32)


def _launch(kernel: str, symbol: str, rows, out, counter, width: int):
    rows, out = C.as_bytes(rows), C.as_bytes(out)
    B, n = rows.shape
    if tuple(out.shape) != (B, width) or tuple(counter.shape) != (n,):
        raise ValueError(f"{kernel}: rows {tuple(rows.shape)}, out "
                         f"{tuple(out.shape)}, counter {tuple(counter.shape)}")
    if counter.dtype != torch.int32 or not counter.is_contiguous():
        raise TypeError(f"{kernel}: counter must be contiguous int32")
    if B == 0 or n == 0:
        return
    p_in, ld_in = C.row_view(rows, f"{kernel} rows")
    p_out, ld_out = C.row_view(out, f"{kernel} out")
    fn = C.bind(build.library("commit"), symbol,
                (C.VOIDP, C.I64, C.VOIDP, C.I64, C.VOIDP, C.I32, C.I32,
                 C.VOIDP))
    err = fn(p_in, ld_in, p_out, ld_out, counter.data_ptr(), B, n, C.stream())
    C.launched(kernel, err)


def arena_commit_cuda(rows, out, counter) -> None:
    _launch(KERNEL, "repro_commit_bitmap", rows, out, counter,
            rows.shape[1])


def arena_commit_packed_cuda(rows, out, counter) -> None:
    _launch(KERNEL_PACKED, "repro_commit_packed", rows, out, counter,
            -(-rows.shape[1] // 8))
