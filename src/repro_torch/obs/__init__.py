"""Observability switchboard (``repro.obs``): metrics (counters, gauges,
histograms) and phase spans.

Instrumented code calls the module-level helpers unconditionally::

    from repro_torch import obs
    with obs.span("sample", tier="engine"):
        ...
    obs.counter("store.rows_written").add(B)
    obs.gauge("store.arena_bytes").set(nbytes)
    obs.histogram("serve.latency_ms").observe(ms)

Disabled (the default), every helper is one flag check returning a
shared no-op; enabled, records are host-side only and never touch a
tensor, so results are bitwise identical with observability on or off.
"""
from __future__ import annotations

import contextlib

from repro_torch.obs.metrics import (                     # noqa: F401
    LATENCY_BUCKETS_MS, SIZE_BUCKETS, Counter, Gauge, Histogram,
    MetricsRegistry, series_key,
)
from repro_torch.obs.tracer import PHASES, Span, Tracer   # noqa: F401

_enabled = False
_registry: MetricsRegistry = MetricsRegistry()
_tracer: Tracer = Tracer()
_NULL_SPAN = contextlib.nullcontext()


class _NoopInstrument:
    __slots__ = ()

    def add(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def percentile(self, p: float) -> float:
        return 0.0

    value = 0
    max = 0.0
    count = 0
    sum = 0.0


_NOOP = _NoopInstrument()


def enable(*, registry: MetricsRegistry = None, tracer: Tracer = None,
           torch_annotations: bool = False) -> None:
    """Turn observability on (idempotent); ``torch_annotations`` bridges
    every span into ``torch.profiler.record_function``."""
    global _enabled, _registry, _tracer
    if registry is not None:
        _registry = registry
    if tracer is not None:
        _tracer = tracer
    elif torch_annotations and _tracer._annotate is None:
        _tracer = Tracer(torch_annotations=True)
    _enabled = True


def disable() -> None:
    """Turn observability off; collected data stays readable through
    `snapshot` and `chrome_trace`."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Disable and drop all collected data."""
    global _enabled, _registry, _tracer
    _enabled = False
    _registry = MetricsRegistry()
    _tracer = Tracer()


def enabled() -> bool:
    return _enabled


def get_metrics() -> MetricsRegistry:
    """The live registry, whatever the switch state."""
    return _registry


def get_tracer() -> Tracer:
    return _tracer


def counter(name: str, **labels):
    return _registry.counter(name, **labels) if _enabled else _NOOP


def gauge(name: str, **labels):
    return _registry.gauge(name, **labels) if _enabled else _NOOP


def histogram(name: str, buckets=None, **labels):
    """`Histogram` for ``(name, labels)``, the shared no-op when disabled;
    ``buckets`` applies on first creation (default
    `LATENCY_BUCKETS_MS`)."""
    if not _enabled:
        return _NOOP
    return _registry.histogram(name, buckets=buckets, **labels)


def span(name: str, *, tier: str = "", **args):
    return _tracer.span(name, tier=tier, **args) if _enabled else _NULL_SPAN


def snapshot() -> dict:
    return _registry.snapshot()


def chrome_trace() -> dict:
    return _tracer.chrome_trace()


def write_metrics(path: str) -> str:
    return _registry.write(path)


def write_trace(path: str) -> str:
    return _tracer.write(path)
