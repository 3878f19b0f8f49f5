"""ic_frontier_step: one probabilistic reverse-BFS step of the dense IC
sampler in the log-semiring,
``new = (rand < -expm1(frontier @ logq)) & ~visited``.

Replaces the TPU kernel ``src/repro/kernels/ic_frontier.py:
ic_frontier_step`` (``_kernel``): a ``(B, n) x (n, n)`` f32 product whose
logits never reach device memory, fused with the Bernoulli test and the
visited mask.

The order of summation is the contract.  For each output ``(b, u)``,
``acc = sum_v frontier[b, v] * logq[v, u]`` is accumulated in float32 in
ascending ``v``, one term at a time, from ``+0.0``.  With ``frontier`` in
{0, 1} a term is ``logq[v, u]`` or a zero, and adding a zero leaves
``acc`` unchanged bit for bit, so any schedule that skips zero terms and
keeps the order of the others gives the same bits (FMA contraction too:
``fma(f, q, acc)`` is ``acc + q`` or ``acc``).  The epilogue, shared with
the dense backend (`activation`), is ``p = float32(-expm1(float64(acc)))``
and ``new = rand < p & ~visited``: float64 ``expm1`` rounded once to f32
gives the same ``p`` on the card and on the host, where the f32 ``expm1``
of two libraries differ.  So the kernel and its plain version agree
bitwise at every shape, on either device.

Bound on an H100: bytes, ``4 n^2 + 7 B n`` (logq read once, the four
``(B, n)`` operands once each) at 3.35 TB/s, 0.33 ms at B = 256,
n = 16,384; the useful operations, one f32 add for each frontier entry
and nonzero of logq's row, are far fewer on a sparse graph.  Design
(``csrc/ic_frontier.cu``): a block per 32-row x 128-column output tile
walks the v-tiles in ascending order, staging 32 frontier columns and the
matching 32 x 128 logq tile in shared memory, 16 accumulators a thread;
a v-tile whose frontier block is all zero is skipped without reading
logq.  Register blocking, TMA or a gather over the frontier's nonzeros
are later work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _common as C
from repro_torch.kernels import build

KERNEL = "ic_frontier_step"


def activation(acc, rand, visited) -> torch.Tensor:
    """``rand < float32(-expm1(float64(acc))) & ~visited`` as bool: the
    epilogue of the kernel, its plain version and the dense backend."""
    p = torch.expm1(acc.to(torch.float64)).neg_().to(torch.float32)
    return (rand < p) & ~visited.to(torch.bool)


def _padded_out(B: int, n: int, device) -> torch.Tensor:
    """A zeroed ``(B, padded_width(n))`` uint8 buffer as its ``[:, :n]``."""
    return torch.zeros((B, C.padded_width(n)), dtype=torch.uint8,
                       device=device)[:, :n]


def column_terms(logq) -> list:
    """logq's nonzeros grouped by rank within their column: a list over
    ranks ``r`` of ``(u, v, q)`` index and value tensors holding, for
    every column ``u`` with more than ``r`` nonzeros, its ``r``-th nonzero
    ``(v, q = logq[v, u])`` in ascending ``v``."""
    u, v = logq.t().nonzero(as_tuple=True)     # sorted by u, then v
    q = logq[v, u]
    counts = torch.bincount(u, minlength=logq.shape[0])
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(u.shape[0], device=logq.device) - starts[u]
    order = torch.argsort(rank, stable=True)
    sizes = torch.bincount(rank).tolist() if rank.numel() else []
    groups, off = [], 0
    for c in sizes:
        idx = order[off:off + c]
        groups.append((u[idx], v[idx], q[idx]))
        off += c
    return groups


def ascending_acc(frontier, logq, terms=None) -> torch.Tensor:
    """``frontier @ logq`` summed as the kernel sums it: logq's nonzeros
    in ascending ``v`` per column, one rank at a time (a gather-add over
    every column that has an ``r``-th nonzero), which equals the dense
    ascending sum because zero terms are exact.  ``terms`` is
    ``column_terms(logq)`` when the caller has built it already."""
    f = frontier.to(torch.float32)
    acc = torch.zeros(f.shape, dtype=torch.float32, device=f.device)
    for u, v, q in column_terms(logq) if terms is None else terms:
        acc[:, u] = acc[:, u] + f[:, v] * q
    return acc


def ic_frontier_step_plain(frontier, visited, logq, rand,
                           terms=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, bitwise its result
    (`ascending_acc`, then `activation`).  Returns a ``(B, n)`` uint8
    view of a row-padded buffer."""
    B, n = frontier.shape
    out = _padded_out(B, n, frontier.device)
    out.copy_(activation(ascending_acc(frontier, logq, terms), rand,
                         visited))
    return out


def _row_block(t: torch.Tensor, what: str) -> tuple[int, int]:
    """``(data_ptr, row_stride)`` of a 2-D block with unit column stride."""
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(f"{KERNEL}: {what} must be a 2-D row block with "
                         f"unit column stride, got shape {tuple(t.shape)} "
                         f"strides {t.stride()}")
    return t.data_ptr(), (t.stride(0) if t.shape[0] > 1 else t.shape[1])


def ic_frontier_step_cuda(frontier, visited, logq, rand) -> torch.Tensor:
    B, n = frontier.shape
    if tuple(visited.shape) != (B, n) or tuple(rand.shape) != (B, n):
        raise ValueError(f"{KERNEL}: frontier {tuple(frontier.shape)}, "
                         f"visited {tuple(visited.shape)} and rand "
                         f"{tuple(rand.shape)} must share one (B, n) shape")
    if tuple(logq.shape) != (n, n) or logq.dtype != torch.float32 \
            or not logq.is_contiguous():
        raise ValueError(f"{KERNEL}: logq must be a contiguous ({n}, {n}) "
                         f"float32 matrix, got {tuple(logq.shape)} "
                         f"{logq.dtype}")
    if rand.dtype != torch.float32:
        raise TypeError(f"{KERNEL}: rand must be float32, got {rand.dtype}")
    if -(-n // 128) > 65535:
        raise ValueError(f"{KERNEL}: n = {n} exceeds the kernel's grid")
    out = _padded_out(B, n, frontier.device)
    if B == 0 or n == 0:
        return out
    f_ptr, ld_f = _row_block(C.as_bytes(frontier), "frontier")
    v_ptr, ld_v = _row_block(C.as_bytes(visited), "visited")
    r_ptr, ld_r = _row_block(rand, "rand")
    fn = C.bind(build.library("ic_frontier"), "repro_ic_frontier_step",
                (C.VOIDP, C.I64, C.VOIDP, C.I64, C.VOIDP, C.VOIDP, C.I64,
                 C.VOIDP, C.I64, C.I32, C.I32, C.VOIDP))
    err = fn(f_ptr, ld_f, v_ptr, ld_v, logq.data_ptr(), r_ptr, ld_r,
             out.data_ptr(), out.stride(0), B, n, C.stream())
    C.launched(KERNEL, err)
    return out
