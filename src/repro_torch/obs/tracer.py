"""Span-based phase tracing with Chrome trace-event export
(``repro.obs.tracer``).

A span is one timed phase on the host clock (``perf_counter_ns`` pair),
nested per thread and recorded on exit.  Export is the Chrome
trace-event format Perfetto loads.  CUDA work is asynchronous, so a
span measures the host's view of a phase: device time lands in the span
that next synchronizes (the sampler's per-step frontier test, a
result's copy to the host).

The optional device bridge (``torch_annotations=True``) enters a
``torch.profiler.record_function(name)`` for every span, so a
``torch.profiler`` trace captured alongside carries the same phase
names as the host spans.  It changes nothing about what executes.
"""
from __future__ import annotations

import json
import threading
import time

#: Phase names the instrumented tiers emit (a catalog, not a closed
#: set — user spans may use any name).
PHASES = (
    "run", "round", "extend", "sample", "store.write", "count",
    "select", "influence", "collective", "compute", "delta",
    "refresh", "admission", "cache", "serve.batch", "replica.sync",
    "flush",
)


class Span:
    """One in-flight phase; a context manager handed out by `Tracer.span`."""

    __slots__ = ("tracer", "name", "tier", "args", "t0", "depth",
                 "parent", "_ann")

    def __init__(self, tracer: "Tracer", name: str, tier: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.tier = tier
        self.args = args
        self.t0 = 0
        self.depth = 0
        self.parent = ""
        self._ann = None

    def __enter__(self) -> "Span":
        stack = self.tracer._stack()
        self.depth = len(stack)
        self.parent = stack[-1].name if stack else ""
        stack.append(self)
        if self.tracer._annotate is not None:
            self._ann = self.tracer._annotate(self.name)
            self._ann.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._ann is not None:
            self._ann.__exit__(*exc)
            self._ann = None
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self.tracer._record(self, t1)
        return False


class Tracer:
    """Collects completed spans; exports Chrome trace-event JSON.
    ``max_events`` bounds memory: past it the oldest events drop."""

    def __init__(self, *, torch_annotations: bool = False,
                 max_events: int = 1 << 20):
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._local = threading.local()
        self._epoch_ns = time.perf_counter_ns()
        self.max_events = int(max_events)
        self.dropped = 0
        self._annotate = None
        if torch_annotations:
            from torch.profiler import record_function
            self._annotate = record_function

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, *, tier: str = "", **args) -> Span:
        return Span(self, name, tier, args)

    def _record(self, span: Span, t1_ns: int) -> None:
        ev = {
            "name": span.name,
            "cat": span.tier or "user",
            "ph": "X",
            "ts": (span.t0 - self._epoch_ns) / 1e3,      # microseconds
            "dur": (t1_ns - span.t0) / 1e3,
            "pid": 0,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": {**span.args, "depth": span.depth,
                     "parent": span.parent},
        }
        with self._lock:
            self._events.append(ev)
            if len(self._events) > self.max_events:
                drop = len(self._events) - self.max_events
                del self._events[:drop]
                self.dropped += drop

    def events(self, name: str = None, tier: str = None) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        if name is not None:
            evs = [e for e in evs if e["name"] == name]
        if tier is not None:
            evs = [e for e in evs if e["cat"] == tier]
        return evs

    def durations_s(self, name: str, tier: str = None) -> list[float]:
        """Every completed ``name`` span's duration in seconds."""
        return [e["dur"] / 1e6 for e in self.events(name, tier)]

    def chrome_trace(self) -> dict:
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        meta = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": "repro-torch-imtrace"},
        }]
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": dropped}}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
        return path
