"""Injectable time source for the serve layer.

Every serve-side timing decision — deadlines, retry backoff sleeps,
heartbeat staleness — goes through a ``Clock`` so the chaos harness
(:mod:`repro_torch.serve.chaos`) can drive the whole failure machinery on a
virtual timeline: a "worker hang" is one deterministic ``sleep`` past the
deadline instead of a real multi-second stall, and the same test runs
bit-identically on any container speed.
"""

from __future__ import annotations

import time


class WallClock:
    """Real monotonic time; production default."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class VirtualClock:
    """Deterministic simulated time: ``sleep`` advances ``now`` instantly.

    The chaos tests run the full deadline / heartbeat / backoff machinery on
    this timeline, so a 30 s hang costs zero wall time and every timing
    decision replays identically across runs and machines."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self.slept = 0.0  # total virtual seconds slept (backoff accounting)

    def now(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self._now += seconds
            self.slept += seconds

    def advance(self, seconds: float) -> None:
        """Move time forward without counting as a sleep (external delay)."""
        self._now += max(seconds, 0.0)
