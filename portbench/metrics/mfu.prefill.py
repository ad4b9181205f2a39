"""Useful prefill work (the frozen count) over the bf16 peak times the
traced window's span, in %."""

from portbench.metrics import _count, _window


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return _window.work(ctx, _count.prefill_flops(ctx.cfg, ctx.batch, ctx.seq))
