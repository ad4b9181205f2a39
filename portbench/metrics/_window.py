"""The arithmetic of the measured window, on the host's clock.

``ctx.items`` holds (start, end) of every request or step the window
completed, back to back from the window's start; the window counts whole
items only and ends at the last completion."""

from __future__ import annotations

import statistics

from portbench.metrics import _count


def span_s(ctx) -> float:
    """From the window's start to its last completion."""
    return ctx.items[-1][1] - ctx.items[0][0]


def rate(ctx) -> float:
    """Tokens of completed items over the span."""
    return len(ctx.items) * ctx.tokens_per_item / span_s(ctx)


def p90_s(ctx) -> float:
    """The 90th percentile of every item's latency."""
    lat = [e - s for s, e in ctx.items]
    if len(lat) < 2:
        return lat[0]
    return statistics.quantiles(lat, n=10, method="inclusive")[8]


def work(ctx, per_item: float):
    """``per_item`` FLOP of useful work an item, as a share in % of the
    bf16 peak over the span; None on a device without a known peak."""
    peak = _count.peaks(ctx.device_kind)
    if peak is None or not ctx.items:
        return None
    return 100.0 * per_item * len(ctx.items) / (peak["bf16_flop_per_s"] * span_s(ctx))


def roofline(ctx, flops: float, nbytes: float, device_s: float):
    """The least time for ``flops`` and ``nbytes`` on the device's peaks
    over ``device_s``, in %; None where nothing was timed."""
    peak = _count.peaks(ctx.device_kind)
    if peak is None or device_s <= 0.0:
        return None
    return 100.0 * _count.roofline_s(flops, nbytes, peak) / device_s


def idle_share(ctx):
    """The traced window's time with no device operation, in %."""
    if ctx.trace is None or ctx.trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
