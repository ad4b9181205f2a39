"""Bounded FIFO request queue with load-shedding backpressure.

The resident study server admits requests through one bounded queue: when
it is full, ``offer`` refuses immediately (the caller gets a
``rejected_overload`` response) instead of growing without bound — under a
request storm the server sheds load at admission and keeps serving what it
already accepted, rather than building an unbounded backlog whose tail
latency (and memory) grows forever.  Single-threaded and deterministic by
design: the serve loop is cooperative (submit / step), so no locks.
"""

from __future__ import annotations

from collections import deque


class BoundedQueue:
    def __init__(self, maxlen: int):
        if maxlen < 1:
            raise ValueError(f"queue maxlen must be >= 1, got {maxlen}")
        self.maxlen = maxlen
        self._q: deque = deque()
        self.shed = 0       # offers refused because the queue was full
        self.accepted = 0   # offers admitted
        self.high_water = 0  # deepest backlog ever held (telemetry)

    def __len__(self) -> int:
        return len(self._q)

    def offer(self, item) -> bool:
        """Admit ``item`` if there is room; False = shed (backpressure)."""
        if len(self._q) >= self.maxlen:
            self.shed += 1
            return False
        self._q.append(item)
        self.accepted += 1
        self.high_water = max(self.high_water, len(self._q))
        return True

    def pop(self):
        """Oldest admitted item, or None when idle."""
        return self._q.popleft() if self._q else None

    def peek(self):
        """Oldest admitted item without removing it, or None when idle —
        lets a policy inspect the head (e.g. its deadline slack) before
        committing to pop it."""
        return self._q[0] if self._q else None

    def take(self, pred) -> list:
        """Remove and return every queued item matching ``pred``, oldest
        first (relative order preserved; non-matching items keep their
        positions).  The coalescer's group-formation primitive: pop the
        head, then ``take`` its compatible peers — a stateful predicate
        can stop matching once the group's lane budget fills."""
        taken, kept = [], []
        for item in self._q:
            (taken if pred(item) else kept).append(item)
        self._q = deque(kept)
        return taken
