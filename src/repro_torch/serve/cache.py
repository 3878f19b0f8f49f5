"""Epoch-keyed sigma(S) result cache (``repro.serve.cache``).

At a consistent store (zero staleness backlog) a sigma(S) answer is a
pure function of ``(tenant, epoch, seed set)``: each epoch has exactly
one consistent store state (refresh repairs stale rows back to what a
fresh engine samples) and the membership count over it is
deterministic, so a cached value is bitwise the recomputed one.  Mid-
repair states change within an epoch, so the tier neither reads nor
writes the cache for them.

The key is ``(tenant, epoch, frozenset(S))``: coverage ignores seed
order and repeats, and the epoch is exactly when an answer can change.
`advance` drops a tenant's entries of every other epoch the moment its
served epoch moves.  Capacity is one LRU over all tenants.
"""
from __future__ import annotations

from collections import OrderedDict


class ResultCache:
    """LRU cache of sigma(S) answers keyed ``(tenant, epoch, frozenset)``."""

    def __init__(self, max_entries: int = 65536):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = int(max_entries)
        self._data: OrderedDict[tuple, float] = OrderedDict()
        self._tenant_keys: dict[str, set] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    @staticmethod
    def key(tenant: str, epoch: int, seeds) -> tuple:
        """The cache key for one query (seed order and repeats erased)."""
        return (tenant, int(epoch), frozenset(int(s) for s in seeds))

    def __len__(self) -> int:
        return len(self._data)

    def entries(self, tenant: str = None) -> int:
        if tenant is None:
            return len(self._data)
        return len(self._tenant_keys.get(tenant, ()))

    def epochs(self, tenant: str) -> set:
        """The epochs the tenant has entries under (at most one after
        `advance`)."""
        return {k[1] for k in self._tenant_keys.get(tenant, ())}

    def get(self, key: tuple):
        """Cached value or None; a hit refreshes LRU recency."""
        val = self._data.get(key)
        if val is None:
            self.misses += 1
            return None
        self._data.move_to_end(key)
        self.hits += 1
        return val

    def put(self, key: tuple, value: float) -> None:
        if key not in self._data and len(self._data) >= self.max_entries:
            old, _ = self._data.popitem(last=False)
            self._tenant_keys[old[0]].discard(old)
            self.evictions += 1
        self._data[key] = float(value)
        self._data.move_to_end(key)
        self._tenant_keys.setdefault(key[0], set()).add(key)

    def advance(self, tenant: str, epoch: int) -> int:
        """The tenant's served epoch moved to ``epoch``: drop its entries
        of every other epoch.  Returns the number dropped."""
        keys = self._tenant_keys.get(tenant)
        if not keys:
            return 0
        dead = [k for k in keys if k[1] != int(epoch)]
        for k in dead:
            del self._data[k]
            keys.discard(k)
        self.invalidations += len(dead)
        return len(dead)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"entries": len(self._data), "hits": self.hits,
                "misses": self.misses, "hit_rate": round(self.hit_rate, 4),
                "evictions": self.evictions,
                "invalidations": self.invalidations}
