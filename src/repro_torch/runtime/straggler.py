"""Straggler detection by a step-time EWMA (``repro.runtime.straggler``).

Steps run in lockstep, so a slow participant shows up as a whole-step
slowdown.  The monitor keeps an EWMA of the step time and flags a step
slower than ``threshold`` times it; flagged steps stay out of the EWMA,
and ``consecutive_flags`` lets the fault-tolerant loop checkpoint and ask
for a new mesh when a device stays slow.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StragglerMonitor:
    alpha: float = 0.2           # EWMA weight of the newest sample
    threshold: float = 2.0       # flag if step_time > threshold * ewma
    warmup_steps: int = 3        # ignore compile-dominated first steps
    ewma: float = 0.0
    seen: int = 0
    consecutive_flags: int = 0
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, step_time: float) -> bool:
        """Record one step; True if it is flagged as straggling."""
        self.seen += 1
        if self.seen <= self.warmup_steps:
            self.ewma = step_time
            return False
        flagged = step_time > self.threshold * max(self.ewma, 1e-9)
        # the EWMA leaves flagged outliers out, so one hiccup does not
        # mask the next
        if not flagged:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time
            self.consecutive_flags = 0
        else:
            self.consecutive_flags += 1
            self.events.append((step, step_time, self.ewma))
        return flagged

    @property
    def unhealthy(self) -> bool:
        """Three or more straggling steps in a row: the re-mesh trigger."""
        return self.consecutive_flags >= 3
