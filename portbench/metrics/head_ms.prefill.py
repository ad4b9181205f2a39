"""Device ms a request of the operations launched under the program's
``model.head`` span: the LM head's product, at every position."""

from portbench.metrics import _spans

RANGES = ("model.head",)


def read(ctx):
    return _spans.device_ms_per_item(ctx, RANGES) if ctx.kind == "prefill" else None
