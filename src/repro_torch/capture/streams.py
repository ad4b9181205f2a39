"""Deterministic request-mix streams for the capture adapters, PyTorch
port of :mod:`repro.capture.streams`.

Every random decision is drawn from the Threefry-2x32 counter PRNG of
:mod:`repro_torch.sim.synth` (the same bits as the reference's), keyed by
``derive_key(app, None, seed, stream-name)``; a :class:`Stream` wraps one
named key with a monotone counter.  The draws are host bookkeeping: the
counter functions run on CPU tensors and return numpy arrays, and the
zipf transform stays in numpy float64 exactly as the reference computes
it (a torch ``pow`` may round differently, and ``floor`` would then move
an id).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.sim import synth


class Stream:
    """One named counter-PRNG stream with a private monotone counter."""

    def __init__(self, app: str, seed: int, name: str):
        self.key = synth.derive_key(app, None, seed, name)
        self._n = 0

    def _ctr(self, k: int) -> torch.Tensor:
        ctr = torch.arange(self._n, self._n + k, dtype=torch.int64)
        self._n += k
        return ctr

    def u01(self, size: int | None = None):
        """Uniform float32(s) in [0, 1)."""
        out = synth.counter_u01(self.key, self._ctr(size or 1)).numpy()
        return float(out[0]) if size is None else out

    def mod(self, bound: int, size: int | None = None):
        """Uniform int(s) in [0, bound)."""
        out = synth.counter_mod(self.key, self._ctr(size or 1), bound).numpy()
        return int(out[0]) if size is None else out.astype(np.int64)

    def zipf(self, n: int, skew: float, size: int | None = None):
        """Zipf-like skewed id(s) in [0, n): ``floor(n * u**skew)`` — rank 0
        is the hot end; larger ``skew`` concentrates harder."""
        u = synth.counter_u01(self.key, self._ctr(size or 1)).numpy()
        ids = np.minimum((n * u.astype(np.float64) ** skew).astype(np.int64),
                         n - 1)
        return int(ids[0]) if size is None else ids


def perm(app: str, seed: int, name: str, n: int) -> np.ndarray:
    """A deterministic permutation of ``range(n)`` (rank -> id)."""
    key = synth.derive_key(app, None, seed, name)
    bits = synth.counter_bits(key, torch.arange(n, dtype=torch.int64)).numpy()
    return np.argsort(bits, kind="stable").astype(np.int64)
