"""Decode-and-count over encoded arenas: ``counter = alive @ bits`` where
the bits rest bit-packed (`packed_count`) or as literal/run tokens
(`token_count`), exact in int32; the decoded ``(theta, n)`` arena never
exists.

Replaces the TPU kernels ``src/repro/kernels/packed_count.py``
(``packed_count``, ``token_count``).  ``alive`` is a 0/1 row mask (bool
or float); rows whose flag is 0 are not read.  Both kernels count with
bit-sliced carry-save planes (``csrc/bitslice.cuh``; `bitplanes_add8`
and `bitplanes_expand` are its arithmetic in PyTorch) and add their
partial counts into the zeroed counter with one integer atomic a column
a block.

packed_count — bound on an H100: bytes, each alive row read once:
``alive_rows * ceil(n / 8)`` bytes (+ theta mask bytes + 4n output),
686 MB with every row alive at theta = 16,384, n = 334,863 (0.205 ms at
3.35 TB/s).  Design: 512-byte column tiles times 32-row units, split
evenly over a persistent grid; a warp reads a unit's alive flags with
one ballot and its alive rows with 16-byte loads, eight rows at a time
(``csrc/packed_count.cu``).

token_count — bound on an H100: bytes, the real tokens (up to each row's
first sentinel) of the alive rows read once (1.17 GB at the kernel rows'
arena, theta 16,384 x s_pad 65,536: 0.348 ms).  Design: 1,024-byte
column spans in groups times row chunks, one block each; per span a warp
reads a row's literal segment from its cursor (`token_segments` gives
where each span's segment starts), scatters it into a shared-memory
stage of the span's packed bytes and the block counts the stage; run
tokens are counted per superblock after the literals
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
SPAN_BYTES = 1024    # kSpanBytes of csrc/token_count.cu
PLANES = 8           # kPlanes of csrc/bitslice.cuh
STEP_ROWS = 8        # rows a carry-save step adds (kStepRows)


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


def bitplanes_add8(P: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``add8`` of ``csrc/bitslice.cuh``: the planes ``P (..., PLANES)``
    plus the eight rows' words ``x (..., STEP_ROWS)``, column by column
    (32-bit words held in int64), through the same carry-save tree."""
    def csa(a, b, c):
        u = a ^ b
        return (a & b) | (u & c), u ^ c          # (carry, sum)

    P = list(P.unbind(-1))
    x = x.unbind(-1)
    twos_a, P[0] = csa(P[0], x[0], x[1])
    twos_b, P[0] = csa(P[0], x[2], x[3])
    fours_a, P[1] = csa(P[1], twos_a, twos_b)
    twos_a, P[0] = csa(P[0], x[4], x[5])
    twos_b, P[0] = csa(P[0], x[6], x[7])
    fours_b, P[1] = csa(P[1], twos_a, twos_b)
    eights, P[2] = csa(P[2], fours_a, fours_b)
    for q in range(3, PLANES):
        P[q], eights = P[q] ^ eights, P[q] & eights
    return torch.stack(P, dim=-1)


def bitplanes_expand(P: torch.Tensor) -> torch.Tensor:
    """``expand`` of ``csrc/bitslice.cuh``: planes ``(..., PLANES)`` ->
    the 32 column counts ``(..., 32)`` of each word (column j is bit j),
    gathered four columns at a time into byte lanes as the kernel does."""
    out = torch.empty(P.shape[:-1] + (32,), dtype=torch.int64,
                      device=P.device)
    for j in range(8):
        v = torch.zeros(P.shape[:-1], dtype=torch.int64, device=P.device)
        for q in range(PLANES):
            v |= ((P[..., q] >> j) & 0x01010101) << q
        for i in range(4):
            out[..., 8 * i + j] = (v >> (8 * i)) & 0xFF
    return out


def token_segments(tokens, n: int, span_bytes: int = SPAN_BYTES):
    """Where each span's literal segment starts in each token row:
    ``(theta, spans + 1)`` int64, entry ``[t, j]`` the index of row t's
    first literal at a block >= ``j * span_bytes`` and entry ``spans``
    the row's first non-literal (where its runs start), spans =
    ``ceil(n_blocks_padded(n) / span_bytes)``.  Row t's literals of span
    j are tokens ``[t, j] .. [t, j + 1] - 1``; this is what
    ``csrc/token_count.cu`` finds with a binary search at a group's
    first span and by walking its cursor after that."""
    from repro_torch.core.pack import codec as pc
    nbp = pc.n_blocks_padded(n)
    spans = -(-nbp // span_bytes)
    bounds = torch.arange(spans + 1, dtype=torch.int64,
                          device=tokens.device) * span_bytes
    bounds[-1] = nbp
    out = torch.empty((tokens.shape[0], spans + 1), dtype=torch.int64,
                      device=tokens.device)
    for s in range(0, tokens.shape[0], PLAIN_CHUNK):
        blk, code = pc._split_tokens(tokens[s:s + PLAIN_CHUNK])
        lit = (code < pc.SAT_CODE) & (blk < nbp)
        key = torch.where(lit, blk, nbp).to(torch.int64)
        out[s:s + PLAIN_CHUNK] = torch.searchsorted(
            key, bounds.expand(key.shape[0], -1).contiguous())
    return out


def packed_count_cuda(packed, alive, n: int) -> torch.Tensor:
    packed = C.as_bytes(packed)
    theta, nb = packed.shape
    if nb != -(-n // 8):
        raise ValueError(f"{KERNEL_PACKED}: {nb} bytes per row do not hold "
                         f"n = {n} columns")
    out = torch.zeros(n, dtype=torch.int32, device=packed.device)
    if n == 0:
        return out
    mask = alive_mask(alive, theta, KERNEL_PACKED)
    ptr, ld = C.row_view(packed, f"{KERNEL_PACKED} packed")
    fn = C.bind(build.library("packed_count"), "repro_packed_count",
                (C.VOIDP, C.I64, C.VOIDP, C.I32, C.I32, C.VOIDP, C.VOIDP))
    with C.on_device(KERNEL_PACKED, packed, mask, out) as stream:
        err = fn(ptr, ld, mask.data_ptr(), theta, n, out.data_ptr(), stream)
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
    out = torch.zeros(n, dtype=torch.int32, device=tokens.device)
    if n == 0:
        return out
    mask = alive_mask(alive, theta, KERNEL_TOKEN)
    run_total = torch.zeros(-(-n // 256), dtype=torch.int32,
                            device=tokens.device)
    fn = C.bind(build.library("token_count"), "repro_token_count",
                (C.VOIDP, C.I64, C.VOIDP, C.I32, C.I32, C.I32, C.VOIDP,
                 C.VOIDP, C.VOIDP))
    with C.on_device(KERNEL_TOKEN, tokens, mask, out) as stream:
        err = fn(tokens.data_ptr(), ld, mask.data_ptr(), theta, s_pad, n,
                 out.data_ptr(), run_total.data_ptr(), stream)
    C.launched(KERNEL_TOKEN, err)
    return out
