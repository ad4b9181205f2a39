"""Device ms a request of the operations launched under the program's
``moe.route``, ``moe.dispatch`` and ``moe.combine`` spans: the MoE layer's
work around the expert products (norm, router, top-k, aux losses, the sort
plan and buffer fill, the gather and weighted sum)."""

from portbench.metrics import _spans

RANGES = ("moe.route", "moe.dispatch", "moe.combine")


def read(ctx):
    return _spans.device_ms_per_item(ctx, RANGES) if ctx.kind == "prefill" else None
