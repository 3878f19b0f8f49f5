"""Read replicas with epoch-consistent snapshot fan-out
(``repro.serve.replica``).

A `ReplicaGroup` keeps ``n`` read-only engine replicas of a primary.  A
``sync`` takes **one** snapshot tree of the primary (under the caller's
tenant lock: one store state, one epoch) and fans it out to every
replica through `InfluenceEngine.replicate` / ``restore_tree(
clone_tree(...))``, so all replicas hold bitwise the same store, tagged
with the epoch it was taken at, and answer as the primary did then.
The tree is host numpy (`repro_torch.checkpoint.store`, the reference's
format): a sync copies the store down once and up once a replica.
Replicas may lag the primary; the tier routes only relaxed-SLO queries
to them.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch import obs
from repro_torch.checkpoint import store as ckpt


def _base_engine(primary):
    """The `InfluenceEngine` under a primary (unwraps a `StreamEngine`)."""
    return primary.engine if hasattr(primary, "engine") else primary


class ReplicaGroup:
    """``n`` epoch-consistent read replicas of one primary engine."""

    def __init__(self, primary, n_replicas: int):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.primary = primary
        self.n_replicas = int(n_replicas)
        self.replicas: list = []
        self.synced_epoch = -1          # no sync yet: group not servable
        self.syncs = 0
        self.bytes_shipped = 0
        self.reads = 0
        self._rr = 0
        self._lock = threading.Lock()

    @property
    def servable(self) -> bool:
        return self.synced_epoch >= 0

    def sync(self, epoch: int = None) -> int:
        """Fan the primary's current store out to every replica (call
        under the tenant lock).  Each replica restores its own copy of
        the one tree (the primary writes its arena in place on its next
        repair); a replica follows the primary's graph when deltas moved
        it.  ``epoch`` tags the group (default: the primary's).  Returns
        the synced epoch and records ``serve.replica_sync_ms``."""
        t0 = time.perf_counter()
        with obs.span("replica.sync", tier="serve",
                      replicas=self.n_replicas):
            base = _base_engine(self.primary)
            tree = base.snapshot_tree()
            per_replica = ckpt.tree_bytes(tree)
            with self._lock:
                if not self.replicas:
                    self.replicas = [base.replicate(tree)
                                     for _ in range(self.n_replicas)]
                else:
                    for r in self.replicas:
                        r.restore_tree(ckpt.clone_tree(tree))
                for r in self.replicas:
                    if r.graph is not base.graph:
                        r.rebind_graph(base.graph)  # deltas moved the graph
                self.synced_epoch = (int(epoch) if epoch is not None
                                     else getattr(self.primary, "epoch", 0))
                self.syncs += 1
                self.bytes_shipped += per_replica * self.n_replicas
        obs.histogram("serve.replica_sync_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        return self.synced_epoch

    def _next(self):
        with self._lock:
            if not self.replicas:
                raise RuntimeError("ReplicaGroup serves only after sync()")
            r = self.replicas[self._rr % len(self.replicas)]
            self._rr += 1
            self.reads += 1
            return r

    # ----------------------------------------------------------- queries

    def influences(self, seed_sets) -> np.ndarray:
        """Batched sigma(S) from the next replica (round-robin)."""
        return self._next().influences(seed_sets)

    def select(self, k: int):
        """Top-k from the next replica (round-robin; each keeps its own
        select memo)."""
        return self._next().select(k)

    def stats(self) -> dict:
        return {"replicas": self.n_replicas, "synced_epoch": self.synced_epoch,
                "syncs": self.syncs, "bytes_shipped": self.bytes_shipped,
                "reads": self.reads}
