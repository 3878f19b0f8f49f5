"""Threefry2x32 keys and draws, bitwise equal to ``jax.random``.

The JAX engine's contract is "seed for seed identical": a fixed
``IMMConfig.seed`` fixes every root, every coin and so every sampled RRR
set.  ``torch.Generator`` draws other numbers, so the port carries its own
counter-mode threefry2x32 (Salmon et al., SC'11) over the same raw
``uint32[2]`` keys that ``jax.random.PRNGKey`` returns, in the
*partitionable* layout (``jax_threefry_partitionable=True``, the default
of jax >= 0.5):

  * ``split(key, num)[i]`` is ``threefry2x32(key, (0, i))`` as a key pair;
  * the 32 random bits of flat element ``i`` of a draw are ``x0 ^ x1`` of
    ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``;
  * ``uniform`` keeps the top 23 bits as the mantissa of a float in
    [1, 2) and subtracts 1; ``randint`` combines two such bit streams
    from ``split(key)`` modulo the span, with uint32 wraparound.

Keys live on the host as numpy ``uint32[2]`` arrays (one split per batch
and per BFS step is host work); draws are torch tensors on any device.
Device arithmetic runs in int32, whose add, multiply and left shift wrap
modulo 2**32 exactly as uint32 does; right shifts are masked to act as
logical shifts.  The ``ic_sparse_hits`` CUDA kernel
(`repro_torch.kernels.coins`) computes the same bits per element.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def u32_to_i32(x: int) -> int:
    """A uint32 value as the int32 with the same bits."""
    return x - (1 << 32) if x & 0x80000000 else x


# ------------------------------------------------------------ host keys ----

def _threefry_scalar(k0: int, k1: int, x0: int, x1: int) -> tuple[int, int]:
    """threefry2x32 of one counter pair in Python ints (the key chain)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def as_key(key) -> np.ndarray:
    """Normalize a raw key (numpy, list, torch tensor) to ``uint32[2]``."""
    if isinstance(key, torch.Tensor):
        key = key.detach().cpu().numpy()
    k = np.asarray(key)
    if k.shape != (2,):
        raise ValueError(f"a raw threefry key has shape (2,), got {k.shape}")
    return (k.astype(np.int64) & MASK32).astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` without x64: ``[0, seed & 0xFFFFFFFF]``
    for a seed in the int32 range (jax rejects larger seeds there too)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise OverflowError(f"seed {seed} does not fit int32")
    return np.array([0, seed & MASK32], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``(num, 2) uint32`` subkeys."""
    k0, k1 = (int(v) for v in as_key(key))
    out = np.empty((num, 2), np.uint32)
    for i in range(num):
        out[i] = _threefry_scalar(k0, k1, i >> 32, i & MASK32)
    return out


# --------------------------------------------------------- device draws ----

def threefry2x32(key, hi: torch.Tensor, lo: torch.Tensor):
    """threefry2x32 over int32 tensors holding uint32 bits; returns the
    two output words (int32, same bits as jax's uint32 result).  Works
    in place on two words and one scratch tensor."""
    k0, k1 = (int(v) for v in as_key(key))
    ks = [u32_to_i32(k0), u32_to_i32(k1), u32_to_i32(k0 ^ k1 ^ _PARITY)]
    x0 = hi + ks[0]
    x1 = lo + ks[1]
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 += x1
            # x1 = rotl(x1, r); the masked right shift acts as a logical one
            torch.bitwise_right_shift(x1, 32 - r, out=tmp)
            tmp &= (1 << r) - 1
            x1 <<= r
            x1 |= tmp
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += u32_to_i32((ks[(i + 2) % 3] + i + 1) & MASK32)
    return x0, x1


def random_bits(key, shape, *, device=None, start: int = 0,
                count: int | None = None) -> torch.Tensor:
    """The 32-bit draw of ``jax.random.bits(key, shape)`` as int32 bits.

    ``start``/``count`` select the flat element range ``[start,
    start + count)`` of the draw (a row block, say) without computing
    the rest: element ``i`` depends only on ``(key, i)``.
    """
    total = math.prod(shape)
    count = total - start if count is None else count
    idx = torch.arange(start, start + count, dtype=torch.int64,
                       device=device)
    hi = (idx >> 32).to(torch.int32)
    lo = (idx & MASK32).to(torch.int32)   # wraps to the uint32 bits
    x0, x1 = threefry2x32(key, hi, lo)
    bits = x0 ^ x1
    return bits if count != total else bits.reshape(shape)


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (in int32) -> float32 in [0, 1): jax's ``_uniform``."""
    mant = ((bits >> 9) & 0x7FFFFF) | 0x3F800000
    return mant.view(torch.float32) - 1.0


def uniform(key, shape, *, device=None, start: int = 0,
            count: int | None = None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32, minval 0, maxval 1)."""
    return bits_to_unit_float(random_bits(key, shape, device=device,
                                          start=start, count=count))


#: ``normal``'s open interval: the float32 after -1, and 1
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_SPAN = float(np.float32(1.0) - np.float32(_NORMAL_LO))


def normal(key, shape, *, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32): ``sqrt(2) *
    erfinv(u)`` with ``u`` uniform on ``(nextafter(-1, 0), 1)``, as jax
    draws it.  The bits are jax's; ``torch.erfinv`` is not XLA's, so a
    value may differ from jax's in its last bits."""
    u = bits_to_unit_float(random_bits(key, shape, device=device))
    u = torch.clamp(u * _NORMAL_SPAN + _NORMAL_LO, min=_NORMAL_LO)
    return torch.erfinv(u) * float(np.float32(np.sqrt(2.0)))


def randint(key, shape, minval: int, maxval: int, *,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32:
    two bit streams from ``split(key)``, combined modulo the span with
    uint32 wraparound (jax's bias-reducing double draw)."""
    minval, maxval = int(minval), int(maxval)
    k1, k2 = split(key)
    hi = random_bits(k1, shape, device=device).to(torch.int64) & MASK32
    lo = random_bits(k2, shape, device=device).to(torch.int64) & MASK32
    span = 1 if maxval <= minval else (maxval - minval) & MASK32
    mult = (((1 << 16) % span) ** 2 & MASK32) % span
    off = ((hi % span) * mult & MASK32) + (lo % span)
    off = (off & MASK32) % span
    return (off + minval).to(torch.int32)
