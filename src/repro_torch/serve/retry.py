"""Retry policy: exponential backoff with deterministic Threefry jitter
(PyTorch port of :mod:`repro.serve.retry`).

Transient engine failures (a dispatch that dies under memory pressure, an
injected chaos exception) are retried with capped exponential backoff.
The jitter that de-synchronizes retrying clients is drawn from the same
counter-based Threefry-2x32 core the trace reference uses
(:func:`repro_torch.sim._traceref.threefry2x32`, bit-equal to the
reference's), keyed on (policy seed, request id, attempt) — so a chaos
replay at a fixed seed reproduces every backoff decision bit for bit, in
either package, with zero RNG state threaded through the serve loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sim._traceref import threefry2x32

# Jitter draws use their own key-1 salt so they can never collide with a
# trace-synthesis stream that happens to share a seed.
_JITTER_SALT = np.uint32(0x5EB0FF)


def _u01(seed: int, rid: int, attempt: int) -> float:
    """Deterministic uniform [0, 1) for (seed, request, attempt)."""
    x0, _ = threefry2x32(np.uint32(seed & 0xFFFFFFFF), _JITTER_SALT,
                         np.uint32(rid & 0xFFFFFFFF),
                         np.uint32(attempt & 0xFFFFFFFF))
    return float(int(x0) >> 8) * 2.0 ** -24


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``max_attempts`` total batched attempts; attempt ``k`` (1-based
    retry index) sleeps ``min(cap, base * 2**(k-1))`` scaled into
    ``[1/2, 1)`` by the deterministic jitter draw."""

    max_attempts: int = 3
    base_s: float = 0.05
    cap_s: float = 2.0
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")

    def backoff_s(self, rid: int, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based) of request ``rid``."""
        raw = min(self.cap_s, self.base_s * 2.0 ** (attempt - 1))
        return raw * (0.5 + 0.5 * _u01(self.seed, rid, attempt))
