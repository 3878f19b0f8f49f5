"""Adaptive RRR-set representation (paper C4, ``repro.core.adaptive``).

Bitmaps cost n bits per set and give O(1) membership and a streaming
column-count counter; index lists cost 32·L bits and give O(L) scatter
counters.  Prefer bitmaps once the average set covers more than
``1/switch_ratio`` of the graph, or when the padded index length would
exceed the bitmap width.

Index lists are ``(theta, L) int32`` rows: a set's members in ascending
order, padded with the sentinel ``n``.  `bitmap_to_indices` keeps the
``L`` smallest members of a longer set, as the reference's ``top_k``
does; it works a block of rows at a time (a running count of members
along each row gives each member its slot), so no ``(theta, n) int32``
score array is ever built.
"""
from __future__ import annotations

import math

import torch

#: elements of a block's ``(rows, n)`` slot array in `bitmap_to_indices`
#: (256 MB of int32)
CONVERT_BLOCK_ELEMS = 1 << 26


def choose_representation(avg_coverage: float, n: int, l_max: int,
                          switch_ratio: int = 32) -> str:
    """Returns "bitmap" or "indices" (paper's dynamic threshold)."""
    if l_max * switch_ratio >= n:
        return "bitmap"
    return "bitmap" if avg_coverage > 1.0 / switch_ratio else "indices"


def l_pad_for(l_max: int) -> int:
    """Padded index-list width for an observed max set size: next power
    of two, floor 4."""
    return 1 << max(int(math.ceil(math.log2(max(l_max, 1)))), 2)


def bitmap_to_indices(R, l_max: int, *, out=None):
    """``(theta, n)`` 0/1 rows -> ``(theta, l_max) int32`` index lists,
    ascending, sentinel ``n``; a row with more than ``l_max`` members
    keeps its ``l_max`` smallest.  ``out`` (``(theta, l_max) int32``)
    receives the lists in place when given."""
    theta, n = R.shape
    l_max = int(l_max)
    if out is None:
        out = torch.empty((theta, l_max), dtype=torch.int32,
                          device=R.device)
    out.fill_(n)
    step = max(1, CONVERT_BLOCK_ELEMS // max(n, 1))
    for lo in range(0, theta, step):
        member = R[lo:lo + step] != 0
        slot = member.cumsum(dim=1, dtype=torch.int32) - 1
        rows, cols = (member & (slot < l_max)).nonzero(as_tuple=True)
        out[lo + rows, slot[rows, cols].long()] = cols.to(torch.int32)
    return out


def indices_to_bitmap(R_idx, n: int):
    """``(theta, L) int32`` (sentinel >= n) -> ``(theta, n) uint8``."""
    theta = R_idx.shape[0]
    idx = torch.where(R_idx < 0, R_idx + n, R_idx)
    idx = torch.where((idx >= 0) & (idx < n), idx, n).long()
    R = torch.zeros((theta, n + 1), dtype=torch.uint8, device=R_idx.device)
    R.scatter_(1, idx, 1)
    return R[:, :n].contiguous()


def set_sizes(R_or_idx, representation: str, n: int):
    """Members of each row: ``(theta,) int32``."""
    if representation == "bitmap":
        return R_or_idx.sum(dim=1, dtype=torch.int32)
    return (R_or_idx < n).sum(dim=1, dtype=torch.int32)
