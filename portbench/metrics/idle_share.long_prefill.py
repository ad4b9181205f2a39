"""The traced window's time with no device operation, in %."""

from portbench.metrics import _window


def read(ctx):
    return _window.idle_share(ctx) if ctx.kind == "prefill" else None
