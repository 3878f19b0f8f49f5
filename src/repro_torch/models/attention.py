"""Attention layers (``repro.models.attention``): RoPE, GQA, sliding
window, the blockwise (flash-style) plain path, and the dispatch that
sends prefill to the ``flash_attention`` kernel on the card.

Layouts are the reference's: ``q (B, Hq, Sq, D)``, ``k, v (B, Hkv, Skv,
D)``.  RoPE is interleaved (pairs ``x[..., 0::2]``, ``x[..., 1::2]``),
not the rotate-half layout of other code bases.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops, ref


# ------------------------------------------------------------------ RoPE ----

def rope_freqs(d_head: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, d_head: int,
                theta: float = 10000.0):
    """``(cos, sin)`` of the rotation angles, f32, ``positions.shape +
    (d_head / 2,)``; computed once for every layer that shares them."""
    freqs = rope_freqs(d_head, theta, positions.device)
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """The interleaved rotation of `apply_rope` by precomputed tables."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, D); positions: broadcastable to (..., S).  The rotation
    runs in f32 (a bf16 x promotes) and is cast back to x's dtype."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


# ------------------------------------------------- blockwise attention -----

def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        chunk: int = 1024, kv_len=None, q_offset=None):
    """Online-softmax attention over KV chunks, in plain PyTorch.

    ``kv_len`` (optional, ``(B,)``) masks cache positions ``>= kv_len``;
    ``q_offset`` (an int) is the absolute position of query 0, by default
    ``Skv - Sq`` (queries right-aligned to the keys).  Masked scores are
    ``-1e30`` and the final division is by ``max(l, 1e-30)``, as in the
    reference, so a row with no admitted key gets the mean of V.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    chunk = min(chunk, Skv)
    dev = q.device
    qg = q.reshape(B, Hkv, group, Sq, D).to(torch.float32) * scale
    if q_offset is None:
        q_offset = Skv - Sq
    qpos = torch.arange(Sq, device=dev) + q_offset
    limit = (torch.full((B,), Skv, device=dev) if kv_len is None
             else torch.as_tensor(kv_len, device=dev))
    m = torch.full((B, Hkv, group, Sq, 1), -1e30, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, group, Sq, D), dtype=torch.float32,
                      device=dev)
    pad = -Skv % chunk
    kf = torch.nn.functional.pad(k.to(torch.float32), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.to(torch.float32), (0, 0, 0, pad))
    for c0 in range(0, Skv, chunk):
        kb, vb = kf[:, :, c0:c0 + chunk], vf[:, :, c0:c0 + chunk]
        kpos = torch.arange(c0, c0 + chunk, device=dev)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb)
        mask = (kpos[None, :] < limit[:, None])[:, None, None, None, :]
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window and window > 0:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              kv_len=None, blockwise_threshold: int = 2048):
    """Dispatch, as the reference's: on CUDA tensors without ``kv_len``
    the ``flash_attention`` kernel; otherwise the blockwise path above
    ``blockwise_threshold`` keys or with ``kv_len``, and the plain
    reference below."""
    if q.device.type == "cuda" and kv_len is None:
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    if k.shape[2] > blockwise_threshold or kv_len is not None:
        return blockwise_attention(q, k, v, causal=causal, window=window,
                                   kv_len=kv_len)
    return ref.attention_ref(q, k, v, causal=causal, window=window)
