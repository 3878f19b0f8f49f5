"""Thread-safe metrics registry: counters and gauges (``repro.obs.metrics``).

Instruments are host-side only and identified by ``(name, labels)``,
rendered into snapshot keys as ``name{k=v,...}`` with sorted keys.
Re-requesting the same identity returns the same instrument.  The
snapshot keeps the reference's JSON schema (``counters``, ``gauges``,
``histograms``), so the same consumers read both packages' files; this
package records no histograms yet.
"""
from __future__ import annotations

import json
import math
import threading


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


class MetricsRegistry:
    """Process-wide instrument table: get-or-create by (name, labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, object] = {}

    def _get(self, cls, name: str, labels: dict):
        key = series_key(name, labels)
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = self._instruments[key] = cls(key)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {key!r} is a {type(inst).__name__}, "
                    f"requested as {cls.__name__}")
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def snapshot(self) -> dict:
        """``{"counters": {key: int}, "gauges": {key: {value, max}},
        "histograms": {}}``."""
        with self._lock:
            items = sorted(self._instruments.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for key, inst in items:
            if isinstance(inst, Counter):
                out["counters"][key] = inst.value
            else:
                out["gauges"][key] = {"value": inst.value, "max": inst.max}
        return out

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path
