"""Attention's share of its roofline in prefill: the frozen count of
causal attention over the device time of the flash-attention kernels, in %."""

from portbench.metrics import _count, _window


def read(ctx):
    if ctx.kind != "prefill" or ctx.trace is None:
        return None
    n = len(ctx.items)
    return _window.roofline(ctx, n * _count.attention_flops(ctx.cfg, ctx.batch, ctx.seq),
                            n * _count.attention_bytes(ctx.cfg, ctx.batch, ctx.seq),
                            ctx.trace.device_s_named("flash_attention"))
