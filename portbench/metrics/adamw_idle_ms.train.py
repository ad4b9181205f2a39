"""Device-idle ms a step while the launching thread is inside the program's
``adamw.step`` span: the window's time with no device operation,
intersected with the span's intervals."""

from portbench.metrics import _spans

RANGES = ("adamw.step",)


def read(ctx):
    return _spans.idle_ms_per_item(ctx, RANGES) if ctx.kind == "train" else None
