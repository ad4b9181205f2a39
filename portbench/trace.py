"""Reading a ``torch.profiler`` trace of the measured window.

The trace is reduced to plain lists: device operations (kernels, copies,
sets) with their intervals and correlation ids, host operations with
theirs, the ``record_function`` ranges, and the host's launch calls.  All
arithmetic on them is here and takes the lists alone, so it runs the same
on a recorded trace and in a test.
"""

from __future__ import annotations

import numpy as np

WINDOW_RANGE = "portbench.window"
_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
             "cudaLaunchCooperativeKernel")


class Trace:
    """``device``: (name, start_ns, end_ns, correlation) of every device
    operation; ``host``: (name, start_ns, end_ns, thread) of every host
    operation; ``ranges``: (name, start_ns, end_ns, thread) of every
    ``record_function`` range; ``launches``: (start_ns, thread, correlation)
    of every launch call.  The window is the range named
    :data:`WINDOW_RANGE`, or else the span of the device operations."""

    def __init__(self, device: list, host: list, ranges: list, launches: list):
        self.device, self.host, self.ranges, self.launches = device, host, ranges, launches
        win = [(s, e) for n, s, e, _ in ranges if n == WINDOW_RANGE]
        if win:
            self.window = win[0]
        elif device:
            self.window = (min(d[1] for d in device), max(d[2] for d in device))
        else:
            self.window = (0, 0)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType

        device, host, ranges, launches = [], [], [], []
        for e in prof.profiler.kineto_results.events():
            name, s, dur = e.name(), e.start_ns(), e.duration_ns()
            cpu = e.device_type() == DeviceType.CPU
            if e.is_user_annotation():
                if cpu:
                    ranges.append((name, s, s + dur, e.start_thread_id()))
            elif not cpu:
                device.append((name, s, s + dur, e.correlation_id()))
            else:
                host.append((name, s, s + dur, e.start_thread_id()))
                if name in _LAUNCHES:
                    launches.append((s, e.start_thread_id(), e.correlation_id()))
        return cls(device, host, ranges, launches)

    # ---- the window -------------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def _clipped(self, ops) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = self.window
        s = np.clip(np.array([o[1] for o in ops], dtype=np.int64), lo, hi)
        e = np.clip(np.array([o[2] for o in ops], dtype=np.int64), lo, hi)
        return s, e

    def busy_segments(self) -> tuple[np.ndarray, np.ndarray]:
        """The union of the device operations' intervals inside the window,
        as sorted disjoint (starts, ends)."""
        if not self.device:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        s, e = self._clipped(self.device)
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        emax = np.maximum.accumulate(e)
        new = np.ones(len(s), dtype=bool)
        new[1:] = s[1:] > emax[:-1]
        first = np.nonzero(new)[0]
        last = np.append(first[1:] - 1, len(s) - 1)
        return s[first], emax[last]

    @property
    def busy_s(self) -> float:
        s, e = self.busy_segments()
        return float((e - s).sum()) / 1e9

    # ---- device time by kernel name and by host range ------------------------

    def device_s(self, ops=None) -> float:
        """Device seconds of ``ops`` (default all), each clipped to the window."""
        ops = self.device if ops is None else ops
        if not ops:
            return 0.0
        s, e = self._clipped(ops)
        return float((e - s).sum()) / 1e9

    def device_s_named(self, fragment: str) -> float:
        """Device seconds of the operations whose name holds ``fragment``."""
        return self.device_s([d for d in self.device if fragment in d[0]])

    def device_s_under(self, names) -> float:
        """Device seconds of the operations launched from inside a host range
        of one of ``names`` (on the launching thread)."""
        by_thread: dict = {}
        for n, s, e, t in self.ranges:
            if n in names:
                by_thread.setdefault(t, []).append((s, e))
        corr = set()
        for t, iv in by_thread.items():
            iv.sort()
            starts = np.array([a for a, _ in iv], dtype=np.int64)
            ends = np.maximum.accumulate(np.array([b for _, b in iv], dtype=np.int64))
            mine = [(s, c) for s, tt, c in self.launches if tt == t]
            if not mine:
                continue
            ls = np.array([s for s, _ in mine], dtype=np.int64)
            idx = np.searchsorted(starts, ls, side="right") - 1
            inside = (idx >= 0) & (ls < ends[np.maximum(idx, 0)])
            corr.update(c for (_, c), keep in zip(mine, inside) if keep)
        return self.device_s([d for d in self.device if d[3] in corr])

    # ---- the breakdown ------------------------------------------------------

    def top_device_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the ``n`` names with most device time."""
        if not self.device:
            return []
        s, e = self._clipped(self.device)
        tot: dict = {}
        for (name, *_), dt in zip(self.device, (e - s).tolist()):
            tot[name] = tot.get(name, 0) + dt
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:64], t / 1e9] for name, t in top]

    def idle_gaps(self, n: int = 10) -> list:
        """[[what the host was doing, seconds]] of the ``n`` longest spans of
        the window in which no device operation ran; the host's activity is
        the innermost host operation open when the gap began."""
        lo, hi = self.window
        s, e = self.busy_segments()
        gap_s = np.concatenate([[lo], e])
        gap_e = np.concatenate([s, [hi]])
        keep = gap_e > gap_s
        gap_s, gap_e = gap_s[keep], gap_e[keep]
        order = np.argsort(gap_s - gap_e, kind="stable")[:n]
        hs = np.array([h[1] for h in self.host], dtype=np.int64)
        he = np.array([h[2] for h in self.host], dtype=np.int64)
        out = []
        for i in order:
            g = gap_s[i]
            open_ = np.nonzero((hs <= g) & (he > g))[0] if len(hs) else []
            what = self.host[open_[np.argmax(hs[open_])]][0] if len(open_) else "no host op"
            out.append([what[:64], float(gap_e[i] - g) / 1e9])
        return out
