"""The arithmetic of the program's spans in a traced window.

A span is a ``record_function`` range the program opens while a profile
records (``repro_torch.models.common.span``).  Each function here takes
the run's context and returns None where the run has no trace or the
window holds no range of the names asked for, as a program without those
spans gives.
"""

from __future__ import annotations

import numpy as np


def intervals(trace, names) -> np.ndarray:
    """The union of the ranges of ``names`` inside the window, as sorted
    disjoint (start_ns, end_ns) rows; empty where there is none."""
    lo, hi = trace.window
    iv = sorted((max(s, lo), min(e, hi)) for n, s, e, _ in trace.ranges
                if n in names and min(e, hi) > max(s, lo))
    out: list = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out, dtype=np.int64).reshape(-1, 2)


def device_ms_per_item(ctx, names):
    """Device ms an item (request or step) of the operations launched under
    a range of ``names``."""
    if ctx.trace is None or not len(intervals(ctx.trace, names)):
        return None
    return 1e3 * ctx.trace.device_s_under(names) / len(ctx.items)


def idle_ms_per_item(ctx, names):
    """Device-idle ms an item inside the ranges of ``names``: the window's
    time with no device operation, intersected with the ranges' union."""
    if ctx.trace is None:
        return None
    iv = intervals(ctx.trace, names)
    if not len(iv):
        return None
    bs, be = ctx.trace.busy_segments()
    busy = 0
    for s, e in iv:
        i = np.searchsorted(be, s, side="right")     # first segment ending after s
        j = np.searchsorted(bs, e, side="left")      # first segment starting at e or later
        if j > i:
            busy += int((np.minimum(be[i:j], e) - np.maximum(bs[i:j], s)).sum())
    return 1e-6 * (int((iv[:, 1] - iv[:, 0]).sum()) - busy) / len(ctx.items)
