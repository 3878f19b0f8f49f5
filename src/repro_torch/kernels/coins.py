"""The positional coins of a BFS step: ``ic_sparse_hits`` (the sparse
backend's coin tests) and ``uniform_draw`` (the dense backends' draw).

``hit[b, e] = uniform(key, (B, m))[b, e] < edge_prob[e]`` with
``uniform`` bitwise jax's partitionable threefry draw (`repro_torch.prng`).
It stands for the ``jax.random.uniform(sub, (batch, m))`` of
``src/repro/core/sampler.py:_sparse_loop`` — not a Pallas kernel (XLA
fuses that draw on the TPU), but in plain torch the draw is ~80 passes of
32-bit arithmetic over a (B, m) tensor per step (466M elements at
B = 256, m = 1,820,024).

Bound on an H100: operations — about `OPS_PER_COIN` 32-bit ALU
operations per element against one byte written (and ``4m`` bytes of
probabilities read).  Design: one thread per element computes its
threefry counter ``b*m + e`` in registers and stores only the bool
(``csrc/coins.cu``).  Both kernels take a first row (a flat start for
the draw), so a theta shard of a mesh batch draws just its row block,
bitwise those rows of the whole batch's draw.

``uniform_draw`` is ``prng.uniform(key, shape)`` itself, the float32
draw the dense and pallas backends test each vertex against (the
``jax.random.uniform(sub, frontier.shape)`` of ``_dense_loop``): the
same per-element threefry, storing the float (4 bytes an element).
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.kernels import _common as C
from repro_torch.kernels import build

KERNEL = "ic_sparse_hits"
KERNEL_UNIFORM = "uniform_draw"
#: 32-bit operations per coin: 2 + 20 rounds x (add, rotate, xor) +
#: 5 key injections x 2 adds, then the 64-bit counter split (2), the
#: output xor, shift, or, float subtract and compare (5)
OPS_PER_COIN = 2 + 20 * 3 + 5 * 2 + 2 + 5
#: rows per chunk of the plain version (bounds its int32 temporaries)
PLAIN_ROWS = 32


def ic_sparse_hits_plain(key, edge_prob, batch: int, rows=None):
    """``prng.uniform(key, (batch, m)) < edge_prob``, computed in row
    chunks; ``rows=(start, stop)`` returns just that row block."""
    m = edge_prob.shape[0]
    start, stop = (0, batch) if rows is None else rows
    out = torch.empty((stop - start, m), dtype=torch.bool,
                      device=edge_prob.device)
    for r in range(start, stop, PLAIN_ROWS):
        r1 = min(r + PLAIN_ROWS, stop)
        u = prng.uniform(key, (batch, m), device=edge_prob.device,
                         start=r * m, count=(r1 - r) * m)
        out[r - start:r1 - start] = u.view(r1 - r, m) < edge_prob
    return out


def ic_sparse_hits_cuda(key, edge_prob, batch: int, rows=None):
    """The kernel's ``(batch, m)`` coin block, or with ``rows=(start,
    stop)`` just those rows (counters from ``start * m``)."""
    if edge_prob.dtype != torch.float32 or not edge_prob.is_contiguous():
        raise TypeError(f"{KERNEL}: edge_prob must be contiguous float32")
    start, stop = (0, batch) if rows is None else (int(r) for r in rows)
    if not 0 <= start < stop <= batch or stop - start > 65535:
        raise ValueError(f"{KERNEL}: rows [{start}, {stop}) of a batch of "
                         f"{batch} (at most 65,535 a launch)")
    m = edge_prob.shape[0]
    out = torch.empty((stop - start, m), dtype=torch.bool,
                      device=edge_prob.device)
    if m == 0:
        return out
    k0, k1 = (int(v) for v in prng.as_key(key))
    fn = C.bind(build.library("coins"), "repro_ic_sparse_hits",
                (C.U32, C.U32, C.VOIDP, C.VOIDP, C.I64, C.I32, C.I64,
                 C.VOIDP))
    with C.on_device(KERNEL, edge_prob, out) as stream:
        err = fn(k0, k1, edge_prob.data_ptr(), out.data_ptr(), m,
                 stop - start, start, stream)
    C.launched(KERNEL, err)
    return out


def uniform_cuda(key, out: torch.Tensor, start: int = 0) -> torch.Tensor:
    """Fill a contiguous float32 CUDA tensor with the flat elements
    ``[start, start + out.numel())`` of a ``prng.uniform(key, ...)``
    draw."""
    if out.dtype != torch.float32 or not out.is_contiguous():
        raise TypeError(f"{KERNEL_UNIFORM}: out must be contiguous float32")
    if out.numel() == 0:
        return out
    k0, k1 = (int(v) for v in prng.as_key(key))
    fn = C.bind(build.library("coins"), "repro_uniform",
                (C.U32, C.U32, C.VOIDP, C.I64, C.I64, C.VOIDP))
    with C.on_device(KERNEL_UNIFORM, out) as stream:
        err = fn(k0, k1, out.data_ptr(), out.numel(), int(start), stream)
    C.launched(KERNEL_UNIFORM, err)
    return out
