"""arena_commit: write a sampled batch into the arena in its at-rest form,
add its column sums to the fused counter and, given ``sizes``, write its
row sums there, in one pass over the batch.

Replaces the TPU kernel ``src/repro/kernels/commit.py:arena_commit``
(``_bitmap_kernel`` for ``kind="bitmap"``, ``_packed_kernel`` for
``kind="packed"``), which returns ``(stored, colsum)`` for a separate
``_commit_write`` to copy into the arena.  Here the kernel stores the
batch straight into ``R[count:count + B]``, adds ``colsum`` into
``store.counter`` in place and writes the batch's row sums into
``store.sizes[count:count + B]``, which the JAX chain sums in the same
jitted program (``src/repro/core/fused.py``).  The packed kind packs
LSB-first, bitwise `repro_torch.core.pack.codec.pack_bits`.

Bound on an H100: bytes — the batch is read once and its at-rest block
written once, plus the ``(n,)`` int32 counter read and written and the
``(B,)`` sizes written: ``2 * B * n + 8 * n + 4 * B`` bytes for the
bitmap kind (174 MB at B = 256, n = 334,863, about 52 µs at 3.35 TB/s),
``B * n + B * ceil(n / 8) + 8 * n + 4 * B`` for the packed kind (99 MB,
about 30 µs).  Design (``csrc/commit.cu``): a persistent grid whose
blocks take balanced, contiguous ranges of (1,024-column strip, row)
pairs; 8 independent 16-byte loads a thread in flight; column counts in
byte, then 16-bit lanes, added to the counter once a strip a block;
row sums reduced in the warp and in shared memory, added into sizes once
a block after the launch zeroes them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _common as C
from repro_torch.kernels import build

KERNEL = "arena_commit"
KERNEL_PACKED = "arena_commit_packed"


def arena_commit_plain(rows, out, counter, sizes=None) -> None:
    """``out[...] = rows; counter += rows.sum(0)``; given ``sizes``,
    ``sizes[...] = rows.sum(1)`` (int32)."""
    out.copy_(rows)
    _sums(rows, counter, sizes)


def arena_commit_packed_plain(rows, out, counter, sizes=None) -> None:
    """``out[...] = pack_bits(rows); counter += rows.sum(0)``; given
    ``sizes``, ``sizes[...] = rows.sum(1)`` (int32)."""
    from repro_torch.core.pack.codec import pack_bits
    out.copy_(pack_bits(rows))
    _sums(rows, counter, sizes)


def _sums(rows, counter, sizes) -> None:
    counter += rows.sum(dim=0, dtype=torch.int32)
    if sizes is not None:
        sizes.copy_(rows.sum(dim=1, dtype=torch.int32))


def _launch(kernel: str, symbol: str, rows, out, counter, sizes,
            width: int):
    rows, out = C.as_bytes(rows), C.as_bytes(out)
    B, n = rows.shape
    if tuple(out.shape) != (B, width) or tuple(counter.shape) != (n,) or (
            sizes is not None and tuple(sizes.shape) != (B,)):
        raise ValueError(
            f"{kernel}: rows {tuple(rows.shape)}, out {tuple(out.shape)}, "
            f"counter {tuple(counter.shape)}, sizes "
            f"{None if sizes is None else tuple(sizes.shape)}")
    for name, t in (("counter", counter), ("sizes", sizes)):
        if t is not None and (t.dtype != torch.int32
                              or not t.is_contiguous()):
            raise TypeError(f"{kernel}: {name} must be contiguous int32")
    if B == 0 or n == 0:
        return
    p_in, ld_in = C.row_view(rows, f"{kernel} rows")
    p_out, ld_out = C.row_view(out, f"{kernel} out")
    fn = C.bind(build.library("commit"), symbol,
                (C.VOIDP, C.I64, C.VOIDP, C.I64, C.VOIDP, C.VOIDP, C.I32,
                 C.I32, C.VOIDP))
    with C.on_device(kernel, rows, out, counter, sizes) as stream:
        err = fn(p_in, ld_in, p_out, ld_out, counter.data_ptr(),
                 None if sizes is None else sizes.data_ptr(), B, n, stream)
    C.launched(kernel, err)


def arena_commit_cuda(rows, out, counter, sizes=None) -> None:
    _launch(KERNEL, "repro_commit_bitmap", rows, out, counter, sizes,
            rows.shape[1])


def arena_commit_packed_cuda(rows, out, counter, sizes=None) -> None:
    _launch(KERNEL_PACKED, "repro_commit_packed", rows, out, counter, sizes,
            -(-rows.shape[1] // 8))
