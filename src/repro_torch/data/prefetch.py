"""Host-side prefetcher (``repro.data.prefetch``): overlaps numpy batch
synthesis with device compute.

One background thread keeps ``depth`` batches ready, so the host's data
path hides behind the device's step; on the host alone it is a FIFO.
"""
from __future__ import annotations

import queue
import threading


class Prefetcher:
    def __init__(self, iterator, depth: int = 2):
        self._it = iterator
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
