"""Streaming influence over a graph that changes (``repro.stream``):

  * `repro_torch.stream.delta`      — `GraphDelta` edge batches (insert /
    delete / reweight) and their application to a graph;
  * `repro_torch.stream.invalidate` — which resident RRR rows a delta
    stales (a column query of the arena itself);
  * `repro_torch.stream.engine`     — `StreamEngine`: ``apply_delta`` /
    ``refresh(budget)`` / epoch-tagged ``select`` and ``influence``, with
    bounded memory through `repro_torch.core.store.StorePressurePolicy`.

For the same graph, deltas and seed every array, row and answer is the
JAX package's, and a stream's snapshot files load in either package.
"""
from repro_torch.stream.delta import GraphDelta, canonicalize, random_delta
from repro_torch.stream.invalidate import invalidate, rows_touching
from repro_torch.stream.engine import StreamEngine, StreamSelection

__all__ = [
    "GraphDelta",
    "canonicalize",
    "random_delta",
    "invalidate",
    "rows_touching",
    "StreamEngine",
    "StreamSelection",
]
