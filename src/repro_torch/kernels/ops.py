"""Kernel dispatch (``repro.kernels.ops``): the CUDA kernel for CUDA
tensors, the plain PyTorch version for CPU tensors, nothing else.

There is no fallback: a CUDA operand launches its kernel or raises
(a missing ``nvcc``, a refused launch, a layout the kernel does not
take).  Each call records ``kernels.dispatch{kernel, impl=cuda|reference}``
on the obs registry (per call: PyTorch runs eagerly, so calls are
executions), and each launch counts in `launch_counts`.
"""
from __future__ import annotations

import math

import torch

from repro_torch import prng
from repro_torch.kernels import coins, commit, coverage_matvec as _cov
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fm_interaction as _fm
from repro_torch.kernels import fused_select as _sel
from repro_torch.kernels import ic_frontier as _icf
from repro_torch.kernels import packed_count as _pc
from repro_torch.kernels._common import (          # noqa: F401
    impl_for, launch_counts, padded_width, reset_launches, row_view,
)

#: the at-rest forms ``arena_commit`` writes
COMMIT_KINDS = ("bitmap", "packed")


def commit_rows(rows) -> torch.Tensor:
    """``rows (K, n)`` 0/1 as a row block ``arena_commit`` reads:
    ``rows`` itself when it is one already (bool or uint8, 16-byte
    aligned rows over a padded stride, as the samplers emit them), else
    a zero-padded uint8 copy."""
    if rows.dtype in (torch.bool, torch.uint8) and rows.dim() == 2:
        try:
            row_view(rows, "rows")
            return rows
        except ValueError:
            pass
    K, n = rows.shape
    block = torch.zeros((K, padded_width(n)), dtype=torch.uint8,
                        device=rows.device)[:, :n]
    block.copy_(rows)
    return block


def arena_commit(rows, out, counter, *, kind: str = "bitmap",
                 sizes=None) -> None:
    """Write ``rows (B, n)`` 0/1 into ``out`` (an arena slice: ``(B, n)``
    for ``kind="bitmap"``, ``(B, ceil(n/8))`` LSB-first packed bytes for
    ``kind="packed"``) and add their int32 column sums into ``counter
    (n,)``, in place; given ``sizes (B,) int32``, write the row sums
    there, whatever it held."""
    if kind == "bitmap":
        name, cuda, plain = (commit.KERNEL, commit.arena_commit_cuda,
                             commit.arena_commit_plain)
    elif kind == "packed":
        name, cuda, plain = (commit.KERNEL_PACKED,
                             commit.arena_commit_packed_cuda,
                             commit.arena_commit_packed_plain)
    else:
        raise ValueError(f"arena_commit kind must be bitmap|packed, "
                         f"got {kind!r}")
    operands = (rows, out, counter) + (() if sizes is None else (sizes,))
    if impl_for(name, *operands) == "cuda":
        cuda(rows, out, counter, sizes)
    else:
        plain(rows, out, counter, sizes)


def coverage_matvec(alive, R):
    """``alive (theta,) 0/1 @ R (theta, n) uint8 -> (n,) float32``."""
    if impl_for(_cov.KERNEL, alive, R) == "cuda":
        return _cov.coverage_matvec_cuda(alive, R)
    return _cov.coverage_matvec_plain(alive, R)


def fused_select(alive, R):
    """``-> (max_count () float32, argmax () int32)`` of ``alive @ R``."""
    if impl_for(_sel.KERNEL, alive, R) == "cuda":
        return _sel.fused_select_cuda(alive, R)
    return _sel.fused_select_plain(alive, R)


def packed_count(packed, alive, *, n: int):
    """``alive (theta,) 0/1 @ unpack(packed (theta, ceil(n/8)))`` ->
    ``(n,) int32``."""
    if impl_for(_pc.KERNEL_PACKED, packed, alive) == "cuda":
        return _pc.packed_count_cuda(packed, alive, n)
    return _pc.packed_count_plain(packed, alive, n)


def token_count(tokens, alive, *, n: int):
    """``alive (theta,) 0/1 @ decode(tokens (theta, s_pad) int32)`` ->
    ``(n,) int32``."""
    if impl_for(_pc.KERNEL_TOKEN, tokens, alive) == "cuda":
        return _pc.token_count_cuda(tokens, alive, n)
    return _pc.token_count_plain(tokens, alive, n)


def uniform(key, shape, *, device, start: int = 0,
            count: int = None) -> torch.Tensor:
    """``prng.uniform(key, shape)`` on ``device``: the ``uniform_draw``
    kernel on a CUDA device, the plain threefry on the CPU.  ``start``/
    ``count`` give just the flat elements ``[start, start + count)`` of
    the draw, flat, as `prng.uniform` does."""
    total = math.prod(shape)
    count = total - start if count is None else int(count)
    out = torch.empty(shape if count == total else (count,),
                      dtype=torch.float32, device=device)
    if impl_for(coins.KERNEL_UNIFORM, out) == "cuda":
        return coins.uniform_cuda(key, out, start)
    return prng.uniform(key, shape, device=out.device, start=start,
                        count=count)


def ic_sparse_hits(key, edge_prob, batch: int, rows=None):
    """``(batch, m) bool``: ``uniform(key, (batch, m)) < edge_prob``;
    ``rows=(start, stop)`` gives just that row block."""
    if impl_for(coins.KERNEL, edge_prob) == "cuda":
        return coins.ic_sparse_hits_cuda(key, edge_prob, batch, rows)
    return coins.ic_sparse_hits_plain(key, edge_prob, batch, rows)


def ic_frontier_step(frontier, visited, logq, rand, *, cols=None):
    """One dense IC BFS step: ``(B, n) uint8`` (a row-padded view) of
    ``rand < -expm1(frontier @ logq) & ~visited``, summed in ascending v
    over logq's nonzeros (`repro_torch.kernels.ic_frontier`).  ``cols``
    is logq's `column_form`, which the kernel and the plain version both
    walk; a caller stepping on one table builds it once and hands it to
    every step.  Without it each call builds the form: a scan of the
    whole ``(n, n)`` logq and a host sync, per call.  Given ``cols``,
    ``logq`` may be None; given both, ``cols`` must be the form built
    from ``logq`` as it stands, else the call raises."""
    if logq is None and cols is None:
        raise ValueError(f"{_icf.KERNEL}: give logq or its column form")
    table = logq if logq is not None else cols.vals
    if impl_for(_icf.KERNEL, frontier, visited, table, rand) == "cuda":
        return _icf.ic_frontier_step_cuda(frontier, visited, logq, rand,
                                          cols)
    return _icf.ic_frontier_step_plain(frontier, visited, logq, rand, cols)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Causal GQA attention with an optional sliding window, queries
    right-aligned to the keys: ``q (B, Hq, Sq, D)``, ``k, v (B, Hkv, Skv,
    D)`` -> ``(B, Hq, Sq, D)`` in q's dtype
    (`repro_torch.kernels.flash_attention`).  On the card the kernel runs
    under `FlashAttention`, whose backward is the plain
    `flash_attention_backward_plain`; on the CPU autograd runs through the
    plain version."""
    if impl_for(_fa.KERNEL, q, k, v) == "cuda":
        return _fa.FlashAttention.apply(q, k, v, causal, window)
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window)


def fm_interaction(v):
    """The FM 2-way term ``0.5 * sum_k ((sum_f v)**2 - sum_f v**2)`` of
    ``v (B, F, K)`` float32/bfloat16 -> ``(B,)`` float32, with the
    reference's gradient (`repro_torch.kernels.fm_interaction`)."""
    return _fm.FMInteraction.apply(v)


def fm_gather_interaction(idx, vocab_per_field: int, v, w, b):
    """The FM logit ``b + sum_f w[row] + fm_interaction(v[row])`` of ids
    ``idx (B, F)``, ``row = idx[:, f] + f * vocab_per_field``, gathered as
    ``jnp.take`` does, from ``v (n, K)``, ``w (n,)``, ``b ()`` ->
    ``(B,)`` float32, in one launch on the card; no gradient
    (`repro_torch.kernels.fm_interaction`)."""
    if impl_for(_fm.KERNEL_GATHER, idx, v, w, b) == "cuda":
        return _fm.fm_gather_interaction_cuda(idx, vocab_per_field, v, w, b)
    return _fm.fm_gather_interaction_plain(idx, vocab_per_field, v, w, b)
