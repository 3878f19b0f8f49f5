"""Adaptive RRR-set representation (paper C4): the chooser only.

Bitmaps cost n bits per set and give O(1) membership and a streaming
column-count counter; index lists cost 32·L bits and give O(L) scatter
counters.  Prefer bitmaps once the average set covers more than
``1/switch_ratio`` of the graph, or when the padded index length would
exceed the bitmap width (``repro.core.adaptive``).  The index-list store
and selection are not ported yet (ROADMAP A3).
"""
from __future__ import annotations

import math


def choose_representation(avg_coverage: float, n: int, l_max: int,
                          switch_ratio: int = 32) -> str:
    """Returns "bitmap" or "indices" (paper's dynamic threshold)."""
    if l_max * switch_ratio >= n:
        return "bitmap"
    return "bitmap" if avg_coverage > 1.0 / switch_ratio else "indices"


def l_pad_for(l_max: int) -> int:
    """Padded index-list width for an observed max set size: next power of
    two, floor 4."""
    return 1 << max(int(math.ceil(math.log2(max(l_max, 1)))), 2)
