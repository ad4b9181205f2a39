"""Device-idle ms a step while the launching thread is inside the program's
``step.train`` span; the rest of ``idle_share.train`` is the harness's
turnaround between steps."""

from portbench.metrics import _spans

RANGES = ("step.train",)


def read(ctx):
    return _spans.idle_ms_per_item(ctx, RANGES) if ctx.kind == "train" else None
