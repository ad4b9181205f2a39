"""Tokens of completed steps over the window's span."""

from portbench.metrics import _window


def read(ctx):
    return _window.rate(ctx) if ctx.kind == "train" else None
