"""Decode-and-count over encoded arenas: ``counter = alive @ bits`` where
the bits rest bit-packed (`packed_count`) or as literal/run tokens
(`token_count`), exact in int32; the decoded ``(theta, n)`` arena never
exists.

Replaces the TPU kernels ``src/repro/kernels/packed_count.py``
(``packed_count``, ``token_count``).  ``alive`` is a 0/1 row mask (bool
or float); rows whose flag is 0 are not read.

packed_count — bound on an H100: bytes, each alive row read once:
``alive_rows * ceil(n / 8)`` bytes (+ theta mask bytes + 4n output),
686 MB with every row alive at theta = 16,384, n = 334,863 (about
0.20 ms at 3.35 TB/s).  Design: a block owns 1,024 columns (128 packed
bytes) and all rows; each thread reads 16 bytes a row with one load and
counts their 128 bits in byte lanes, drained into shared memory
(``csrc/packed_count.cu``).

token_count — bound on an H100: bytes, the real tokens (up to each row's
first sentinel) of the alive rows read once.  Design: a scan pass finds
each 1,024-column tile's literals in every alive row and counts run
tokens per superblock; a tile pass stages each row's literals of the
tile in shared memory and counts them as packed_count does
(``csrc/token_count.cu``).  Rows must be in the codec's order (literals
by block, then runs, then sentinels), as `token_encode` writes them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _common as C
from repro_torch.kernels import build
from repro_torch.kernels.coverage_matvec import alive_mask

KERNEL_PACKED = "packed_count"
KERNEL_TOKEN = "token_count"
#: rows per decoded chunk of the plain versions (bounds their copy)
PLAIN_CHUNK = 1024
TILE_BYTES = 128     # kTileBytes of csrc/token_count.cu


def _count_chunks(arena, alive, n: int, decode) -> torch.Tensor:
    """``sum_t alive[t] * decode(arena[t])`` in row chunks (int32)."""
    mask = (alive if alive.dtype == torch.bool else alive != 0).to(
        torch.uint8).view(-1, 1)
    out = torch.zeros(n, dtype=torch.int32, device=arena.device)
    for s in range(0, arena.shape[0], PLAIN_CHUNK):
        bits = decode(arena[s:s + PLAIN_CHUNK], n)
        out += (bits & mask[s:s + PLAIN_CHUNK]).sum(dim=0, dtype=torch.int32)
    return out


def packed_count_plain(packed, alive, n: int) -> torch.Tensor:
    """Unpack to 0/1 bits, then the masked column sum."""
    from repro_torch.core.pack.codec import unpack_bits
    return _count_chunks(packed, alive, n, unpack_bits)


def token_count_plain(tokens, alive, n: int) -> torch.Tensor:
    """Decode the token rows to 0/1 bits, then the masked column sum."""
    from repro_torch.core.pack.codec import token_decode
    return _count_chunks(tokens, alive, n, token_decode)


def packed_count_cuda(packed, alive, n: int) -> torch.Tensor:
    packed = C.as_bytes(packed)
    theta, nb = packed.shape
    if nb != -(-n // 8):
        raise ValueError(f"{KERNEL_PACKED}: {nb} bytes per row do not hold "
                         f"n = {n} columns")
    out = torch.empty(n, dtype=torch.int32, device=packed.device)
    if n == 0:
        return out
    mask = alive_mask(alive, theta, KERNEL_PACKED)
    ptr, ld = C.row_view(packed, f"{KERNEL_PACKED} packed")
    fn = C.bind(build.library("packed_count"), "repro_packed_count",
                (C.VOIDP, C.I64, C.VOIDP, C.I32, C.I32, C.VOIDP, C.VOIDP))
    err = fn(ptr, ld, mask.data_ptr(), theta, n, out.data_ptr(), C.stream())
    C.launched(KERNEL_PACKED, err)
    return out


def token_count_cuda(tokens, alive, n: int) -> torch.Tensor:
    if tokens.dtype != torch.int32 or tokens.dim() != 2:
        raise TypeError(f"{KERNEL_TOKEN}: need (theta, s_pad) int32 tokens, "
                        f"got {tokens.dtype} {tuple(tokens.shape)}")
    theta, s_pad = tokens.shape
    ld = tokens.stride(0) if theta > 1 else s_pad
    if tokens.stride(1) != 1 and s_pad > 1:
        raise ValueError(f"{KERNEL_TOKEN}: token rows need a unit column "
                         f"stride, got strides {tokens.stride()}")
    out = torch.empty(n, dtype=torch.int32, device=tokens.device)
    if n == 0:
        return out
    mask = alive_mask(alive, theta, KERNEL_TOKEN)
    nb = -(-n // 8)
    tiles = -(-nb // TILE_BYTES)
    off = torch.empty((tiles + 1) * max(theta, 1), dtype=torch.int32,
                      device=tokens.device)
    run_cnt = torch.zeros(-(-nb // 32), dtype=torch.int32,
                          device=tokens.device)
    fn = C.bind(build.library("token_count"), "repro_token_count",
                (C.VOIDP, C.I64, C.VOIDP, C.I32, C.I32, C.I32, C.VOIDP,
                 C.VOIDP, C.VOIDP, C.VOIDP))
    err = fn(tokens.data_ptr(), ld, mask.data_ptr(), theta, s_pad, n,
             off.data_ptr(), run_cnt.data_ptr(), out.data_ptr(), C.stream())
    C.launched(KERNEL_TOKEN, err)
    return out
