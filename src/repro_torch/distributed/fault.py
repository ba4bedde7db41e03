"""Straggler detection for the replicated serve tier: per-step wall times
are watermarked against their trailing median, and steps slower than
``straggler_factor`` times it are logged and counted; after
``max_strikes`` the policy asks for a re-shard (a recorded decision).
Mirrors ``repro/distributed/fault.py::StragglerPolicy``; the restartable
training ``Runner`` beside it there is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from statistics import median


@dataclass
class StragglerPolicy:
    straggler_factor: float = 2.0
    max_strikes: int = 3
    window: int = 20
    _times: list = field(default_factory=list)
    strikes: int = 0
    events: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> str:
        """Returns "ok" | "straggler" | "reshard"."""
        self._times = (self._times + [dt])[-self.window:]
        if len(self._times) < 5:
            return "ok"
        med = median(self._times[:-1])
        if dt > self.straggler_factor * med:
            self.strikes += 1
            self.events.append((step, dt, med))
            if self.strikes >= self.max_strikes:
                self.strikes = 0
                return "reshard"
            return "straggler"
        return "ok"
