"""The 90th percentile of every request's latency in the window."""

from portbench.metrics import _window


def read(ctx):
    return 1e3 * _window.p90_s(ctx) if ctx.kind == "prefill" else None
