"""Thread-safe metrics registry: counters, gauges and fixed-bucket
histograms (``repro.obs.metrics``).

Instruments are host-side only and identified by ``(name, labels)``,
rendered into snapshot keys as ``name{k=v,...}`` with sorted keys.
Re-requesting the same identity returns the same instrument.  The
snapshot keeps the reference's JSON schema (``counters``, ``gauges``,
``histograms``), so the same consumers read both packages' files.

A `Histogram`'s quantiles are bucket-resolution: the reported p50/p99 is
the smallest bucket upper bound covering that rank (exact when values
sit on bucket bounds); exact ``count``/``sum``/``min``/``max`` ride
along, and values past the last bound land in a ``+Inf`` bucket whose
quantile is the observed max.
"""
from __future__ import annotations

import json
import math
import threading

#: Default latency buckets (milliseconds), roughly x2.5 a step.
LATENCY_BUCKETS_MS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)

#: Default size buckets (rows, bytes, queue depths): powers of four.
SIZE_BUCKETS = tuple(float(1 << i) for i in range(0, 31, 2))


def series_key(name: str, labels: dict) -> str:
    """Canonical snapshot key: ``name`` or ``name{k=v,...}`` (sorted)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter; negative increments are rejected."""

    __slots__ = ("key", "_lock", "_value")

    def __init__(self, key: str):
        self.key = key
        self._lock = threading.Lock()
        self._value = 0

    def add(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.key!r}: add({n}) is negative")
        with self._lock:
            self._value += int(n)

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-value gauge with a running max."""

    __slots__ = ("key", "_lock", "_value", "_max", "_written")

    def __init__(self, key: str):
        self.key = key
        self._lock = threading.Lock()
        self._value = 0.0
        self._max = -math.inf
        self._written = False

    def set(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._value = v
            self._max = v if v > self._max else self._max
            self._written = True

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def max(self) -> float:
        with self._lock:
            return self._max if self._written else 0.0


class Histogram:
    """Fixed-bucket histogram: ``buckets`` are ascending inclusive upper
    bounds; a value lands in the first bucket whose bound is >= it, or
    in the overflow (``+Inf``) bucket past the last bound."""

    __slots__ = ("key", "buckets", "_lock", "_counts", "_count", "_sum",
                 "_min", "_max")

    def __init__(self, key: str, buckets=LATENCY_BUCKETS_MS):
        buckets = tuple(float(b) for b in buckets)
        if not buckets:
            raise ValueError(f"histogram {key!r}: needs >= 1 bucket")
        if any(b2 <= b1 for b1, b2 in zip(buckets, buckets[1:])):
            raise ValueError(
                f"histogram {key!r}: bucket bounds must be strictly "
                f"ascending, got {buckets}")
        self.key = key
        self.buckets = buckets
        self._lock = threading.Lock()
        self._counts = [0] * (len(buckets) + 1)   # +1: overflow (+Inf)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def _bucket_of(self, v: float) -> int:
        lo, hi = 0, len(self.buckets)     # hi == overflow
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def observe(self, v: float) -> None:
        v = float(v)
        i = self._bucket_of(v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            self._min = v if v < self._min else self._min
            self._max = v if v > self._max else self._max

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, p: float) -> float:
        """The smallest bucket bound whose cumulative count reaches rank
        ``ceil(p/100 * count)`` (the observed max in the overflow
        bucket); 0.0 when empty."""
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile wants p in [0, 100], got {p}")
        with self._lock:
            if self._count == 0:
                return 0.0
            rank = max(1, math.ceil(p / 100.0 * self._count))
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= rank:
                    return (self.buckets[i] if i < len(self.buckets)
                            else self._max)
            return self._max

    def to_dict(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            count, total = self._count, self._sum
            mn = self._min if self._count else 0.0
            mx = self._max if self._count else 0.0
        d = {"count": count, "sum": total, "min": mn, "max": mx,
             "p50": self.percentile(50.0), "p99": self.percentile(99.0),
             "buckets": [[b, c] for b, c in zip(self.buckets, counts)]}
        d["buckets"].append(["+Inf", counts[-1]])
        return d


class MetricsRegistry:
    """Process-wide instrument table: get-or-create by (name, labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, object] = {}

    def _get(self, cls, name: str, labels: dict, **kw):
        key = series_key(name, labels)
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = self._instruments[key] = cls(key, **kw)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {key!r} is a {type(inst).__name__}, "
                    f"requested as {cls.__name__}")
            elif kw.get("buckets") and inst.buckets != tuple(
                    float(b) for b in kw["buckets"]):
                raise ValueError(
                    f"histogram {key!r} already registered with buckets "
                    f"{inst.buckets}")
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, buckets=None, **labels) -> Histogram:
        kw = {"buckets": buckets} if buckets is not None else {}
        return self._get(Histogram, name, labels, **kw)

    def snapshot(self) -> dict:
        """``{"counters": {key: int}, "gauges": {key: {value, max}},
        "histograms": {key: {count, sum, min, max, p50, p99, buckets}}}``."""
        with self._lock:
            items = sorted(self._instruments.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for key, inst in items:
            if isinstance(inst, Counter):
                out["counters"][key] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][key] = {"value": inst.value, "max": inst.max}
            else:
                out["histograms"][key] = inst.to_dict()
        return out

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path
