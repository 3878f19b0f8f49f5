"""Row codecs for RRR arenas: bitmap, bit-packed and token-compressed
(``repro.core.pack.codec``).

A codec maps a batch of RRR membership rows — uint8 0/1 bitmaps of shape
``(B, n_cols)`` — to an at-rest representation and back.  Every function
here gives the reference's output bit for bit on the same input.

At-rest formats
---------------
* ``bitmap`` — the identity codec: one uint8 per vertex.
* ``packed`` — 8 vertices per byte, ``width = ceil(n_cols / 8)``.
  Bit ``j`` of byte ``b`` is vertex ``b * 8 + j`` (LSB-first).
* ``compressed`` — per-row token lists over the *packed* bytes, mixing
  two codes chosen per 32-byte superblock by density:

      token = block * 512 + code
      code < 256   -> dictionary literal: byte ``block`` equals ``code``
      code == 256  -> saturated run: 32 consecutive 0xFF bytes starting
                      at ``block`` (block % 32 == 0), i.e. 256 set bits
      sentinel     -> ``n_blocks_padded * 512`` (past-the-end block,
                      code 0: decodes to nothing)

  Within a row the literals come first, sorted by block, then the run
  tokens sorted by block, then sentinels up to ``s_pad``.  No two tokens
  of a row set the same bit (a saturated superblock emits no literal).

Where the reference compacts candidates with ``lax.top_k`` over a score,
`token_encode` uses a cumulative sum and a scatter: the same stable
order.  `token_decode_cols` works in row chunks, so a query against a
``(theta, s_pad)`` arena never broadcasts more than `DECODE_ELEMS`
booleans at once.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

TOKEN_BASE = 512       # tokens are block * TOKEN_BASE + code
TOKEN_SHIFT = 9        # log2(TOKEN_BASE): block = token >> 9
SAT_CODE = 256         # code marking a saturated 32-byte run
SUPERBLOCK = 32        # bytes per run-length superblock
MIN_TOKEN_PAD = 8      # floor for CompressedStore s_pad

#: bound on the (rows, s_pad, cols) broadcast of one `token_decode_cols`
#: chunk
DECODE_ELEMS = 1 << 26


def n_bytes_for(n_cols: int) -> int:
    """Packed width in bytes for an ``n_cols``-bit row."""
    return -(-int(n_cols) // 8)


def n_superblocks_for(n_cols: int) -> int:
    return -(-n_bytes_for(n_cols) // SUPERBLOCK)


def n_blocks_padded(n_cols: int) -> int:
    """Byte count rounded up to whole superblocks (token block space)."""
    return n_superblocks_for(n_cols) * SUPERBLOCK


def token_sentinel(n_cols: int) -> int:
    return n_blocks_padded(n_cols) * TOKEN_BASE


def _pad_last(t: torch.Tensor, width: int, value=0) -> torch.Tensor:
    """``t`` padded along its last axis to ``width`` with ``value``."""
    extra = width - t.shape[-1]
    if extra <= 0:
        return t
    pad = torch.full(t.shape[:-1] + (extra,), value, dtype=t.dtype,
                     device=t.device)
    return torch.cat([t, pad], dim=-1)


# ---------------------------------------------------------------------------
# bit packing


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., n) uint8 0/1 -> (..., ceil(n/8)) uint8, LSB-first."""
    nb = n_bytes_for(bits.shape[-1])
    grouped = _pad_last(bits.to(torch.uint8), nb * 8).reshape(
        bits.shape[:-1] + (nb, 8))
    out = grouped[..., 0].clone()
    for j in range(1, 8):
        out |= grouped[..., j] << j
    return out


def unpack_bits(packed: torch.Tensor, n_cols: int) -> torch.Tensor:
    """(..., nb) uint8 -> (..., n_cols) uint8 0/1 (inverse of pack_bits)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.to(torch.uint8)[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (-1,))[..., :n_cols]


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    return np.packbits(bits, axis=-1, bitorder="little")


def unpack_bits_np(packed: np.ndarray, n_cols: int) -> np.ndarray:
    out = np.unpackbits(np.ascontiguousarray(packed, dtype=np.uint8),
                        axis=-1, bitorder="little")
    return out[..., :n_cols]


def popcount_u8(x: torch.Tensor) -> torch.Tensor:
    """Per-byte population count (uint8 in, uint8 out)."""
    x = x.to(torch.uint8)
    v = x - ((x >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    return (v + (v >> 4)) & 0x0F


def popcount_i32(x: torch.Tensor) -> torch.Tensor:
    """Population count of non-negative int32 values (int32 out).  The
    final multiply runs in int64 and keeps the low 32 bits, which is the
    reference's wrapping int32 product."""
    v = x.to(torch.int64)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


# ---------------------------------------------------------------------------
# token codec primitives


def _row_plan(bits: torch.Tensor):
    """Per-row byte/superblock masks behind the token layout:
    ``(bytes_, lit_mask, sat_mask)`` — the superblock-padded packed row,
    the bytes emitted as dictionary literals, and the saturated
    superblocks emitted as one run token each."""
    nbp = n_blocks_padded(bits.shape[-1])
    bytes_ = _pad_last(pack_bits(bits), nbp)
    grouped = bytes_.reshape(bytes_.shape[:-1] + (-1, SUPERBLOCK))
    sat_mask = (grouped == 0xFF).all(dim=-1)
    lit_mask = (bytes_ > 0) & ~sat_mask.repeat_interleave(SUPERBLOCK, dim=-1)
    return bytes_, lit_mask, sat_mask


def tokens_needed(bits: torch.Tensor) -> torch.Tensor:
    """(..., n) bit rows -> (...,) int32 token count under the codec."""
    _, lit_mask, sat_mask = _row_plan(bits)
    return (lit_mask.sum(dim=-1, dtype=torch.int32)
            + sat_mask.sum(dim=-1, dtype=torch.int32))


def token_encode(bits: torch.Tensor, s_pad: int) -> torch.Tensor:
    """(B, n) bit rows -> (B, s_pad) int32 tokens (sentinel padded).

    The caller must guarantee ``s_pad >= tokens_needed(bits).max()`` —
    overflow tokens are dropped (stores widen first)."""
    n = bits.shape[-1]
    nbp = n_blocks_padded(n)
    nsb = nbp // SUPERBLOCK
    dev = bits.device
    bytes_, lit_mask, sat_mask = _row_plan(bits)
    lit_vals = (torch.arange(nbp, dtype=torch.int32, device=dev) * TOKEN_BASE
                + bytes_.to(torch.int32))
    sat_vals = (torch.arange(nsb, dtype=torch.int32, device=dev)
                * (SUPERBLOCK * TOKEN_BASE) + SAT_CODE)
    vals = torch.cat([lit_vals, sat_vals.expand(bits.shape[:-1] + (nsb,))],
                     dim=-1)
    mask = torch.cat([lit_mask, sat_mask], dim=-1)
    # stable compaction: candidate i lands at (masked candidates before
    # it); unmasked and overflowing ones go to a dump column
    pos = torch.cumsum(mask, dim=-1) - 1
    pos = torch.where(mask & (pos < s_pad), pos, s_pad)
    out = torch.full(bits.shape[:-1] + (s_pad + 1,), token_sentinel(n),
                     dtype=torch.int32, device=dev)
    out.scatter_(-1, pos, vals)
    return out[..., :s_pad].contiguous()


def _split_tokens(tokens: torch.Tensor):
    """``(block, code)`` of non-negative int32 tokens."""
    tokens = tokens.to(torch.int32)
    return tokens >> TOKEN_SHIFT, tokens & (TOKEN_BASE - 1)


def token_decode(tokens: torch.Tensor, n_cols: int) -> torch.Tensor:
    """(B, s_pad) int32 tokens -> (B, n_cols) uint8 0/1 bit rows."""
    nbp = n_blocks_padded(n_cols)
    nsb = nbp // SUPERBLOCK
    blk, code = _split_tokens(tokens)
    rows = tokens.shape[:-1]
    dev = tokens.device
    # literal bytes scatter into a one-slot-padded scratch, so the
    # sentinel block (== nbp) and run tokens land harmlessly
    lit = code < SAT_CODE
    lit_idx = torch.where(lit, blk, nbp).clamp_(max=nbp).long()
    bytes_ = torch.zeros(rows + (nbp + 1,), dtype=torch.int32, device=dev)
    bytes_.scatter_reduce_(-1, lit_idx, torch.where(lit, code, 0), "amax")
    sat_idx = torch.where(code == SAT_CODE, blk // SUPERBLOCK, nsb)
    sat = torch.zeros(rows + (nsb + 1,), dtype=torch.int32, device=dev)
    sat.scatter_reduce_(-1, sat_idx.clamp_(max=nsb).long(),
                        torch.ones_like(sat_idx), "amax")
    full = sat[..., :nsb].repeat_interleave(SUPERBLOCK, dim=-1) * 0xFF
    packed = torch.maximum(bytes_[..., :nbp], full).to(torch.uint8)
    return unpack_bits(packed, n_cols)


def token_decode_cols(tokens: torch.Tensor, cols) -> torch.Tensor:
    """Membership of global columns: (B, s_pad), (L,) -> (B, L) bool.
    Works in row chunks of at most `DECODE_ELEMS` broadcast elements."""
    cols = torch.as_tensor(cols, device=tokens.device).to(torch.int32)
    cblk = cols >> 3
    cbit = cols & 7
    csb = (cblk // SUPERBLOCK) * SUPERBLOCK
    B, s_pad = tokens.shape[0], tokens.shape[-1]
    step = max(1, DECODE_ELEMS // max(s_pad * cols.numel(), 1))
    out = torch.empty((B, cols.numel()), dtype=torch.bool,
                      device=tokens.device)
    for s in range(0, B, step):
        blk, code = _split_tokens(tokens[s:s + step])
        blk, code = blk[..., None], code[..., None]
        lit = ((code < SAT_CODE) & (blk == cblk)
               & (((code >> cbit) & 1) > 0))
        sat = (code == SAT_CODE) & (blk == csb)
        out[s:s + step] = (lit | sat).any(dim=-2)
    return out


def token_row_popcount(tokens: torch.Tensor) -> torch.Tensor:
    """(B, s_pad) tokens -> (B,) int32 set-bit counts (no decode)."""
    _, code = _split_tokens(tokens)
    per = torch.where(code == SAT_CODE, SUPERBLOCK * 8, popcount_i32(code))
    return per.sum(dim=-1, dtype=torch.int32)


def token_decode_np(tokens: np.ndarray, n_cols: int) -> np.ndarray:
    """Host-side token decode for snapshot paths."""
    tokens = np.asarray(tokens, dtype=np.int64)
    nbp = n_blocks_padded(n_cols)
    blk = tokens // TOKEN_BASE
    code = tokens - blk * TOKEN_BASE
    out = np.zeros(tokens.shape[:-1] + (nbp,), dtype=np.uint8)
    rows = np.broadcast_to(
        np.arange(tokens.shape[0])[:, None], tokens.shape)
    # sentinel tokens live at the past-the-end block — not literals
    lit = (code < SAT_CODE) & (blk < nbp)
    out[rows[lit], blk[lit]] = code[lit].astype(np.uint8)
    sat = code == SAT_CODE
    for r, b in zip(rows[sat], blk[sat]):
        out[r, b:b + SUPERBLOCK] = 0xFF
    return unpack_bits_np(out, n_cols)


# ---------------------------------------------------------------------------
# codec objects


@dataclasses.dataclass(frozen=True)
class BitmapCodec:
    """Identity codec: one uint8 per vertex."""
    n_cols: int
    kind: ClassVar[str] = "bitmap"
    dtype: ClassVar = torch.uint8

    @property
    def width(self) -> int:
        return self.n_cols

    @property
    def fill(self) -> int:
        return 0

    def encode(self, bits):
        return bits.to(torch.uint8)

    def decode(self, stored):
        return stored

    def decode_cols(self, stored, cols):
        cols = torch.as_tensor(cols, device=stored.device).long()
        return stored.index_select(-1, cols) > 0

    def row_popcount(self, stored):
        return stored.sum(dim=-1, dtype=torch.int32)

    def decode_np(self, stored: np.ndarray) -> np.ndarray:
        return np.asarray(stored, dtype=np.uint8)


@dataclasses.dataclass(frozen=True)
class PackedCodec:
    """Bit-packed codec: 8 vertices per byte, 8x smaller at rest."""
    n_cols: int
    kind: ClassVar[str] = "packed"
    dtype: ClassVar = torch.uint8

    @property
    def width(self) -> int:
        return n_bytes_for(self.n_cols)

    @property
    def fill(self) -> int:
        return 0

    def encode(self, bits):
        return pack_bits(bits)

    def decode(self, stored):
        return unpack_bits(stored, self.n_cols)

    def decode_cols(self, stored, cols):
        cols = torch.as_tensor(cols, device=stored.device).long()
        bytes_ = stored.index_select(-1, cols >> 3)
        return ((bytes_ >> (cols & 7).to(torch.uint8)) & 1) > 0

    def row_popcount(self, stored):
        return popcount_u8(stored).sum(dim=-1, dtype=torch.int32)

    def decode_np(self, stored: np.ndarray) -> np.ndarray:
        return unpack_bits_np(stored, self.n_cols)


@dataclasses.dataclass(frozen=True)
class TokenCodec:
    """Compressed-at-rest codec: per-row literal/run token lists."""
    n_cols: int
    s_pad: int
    kind: ClassVar[str] = "compressed"
    dtype: ClassVar = torch.int32

    @property
    def width(self) -> int:
        return self.s_pad

    @property
    def fill(self) -> int:
        return token_sentinel(self.n_cols)

    def encode(self, bits):
        return token_encode(bits, self.s_pad)

    def decode(self, stored):
        return token_decode(stored, self.n_cols)

    def decode_cols(self, stored, cols):
        return token_decode_cols(stored, cols)

    def row_popcount(self, stored):
        return token_row_popcount(stored)

    def decode_np(self, stored: np.ndarray) -> np.ndarray:
        return token_decode_np(stored, self.n_cols)


def codec_for(kind: str, n_cols: int, s_pad: int = MIN_TOKEN_PAD):
    """Build the codec named ``kind`` (``bitmap``/``packed``/
    ``compressed``) for ``n_cols``-wide rows."""
    if kind == "bitmap":
        return BitmapCodec(int(n_cols))
    if kind == "packed":
        return PackedCodec(int(n_cols))
    if kind == "compressed":
        return TokenCodec(int(n_cols), int(s_pad))
    raise ValueError(
        f"unknown codec kind {kind!r}; expected one of "
        "'bitmap', 'packed', 'compressed'")
