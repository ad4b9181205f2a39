"""The window's span over the requests it completed: the time to first
token of one long document."""

from portbench.metrics import _window


def read(ctx):
    return 1e3 * _window.span_s(ctx) / len(ctx.items) if ctx.kind == "prefill" else None
