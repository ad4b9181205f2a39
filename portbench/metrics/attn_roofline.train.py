"""Attention's share of its roofline in training: the frozen count of its
forward and backward over the device time of the kernels launched under
the program's ``flash_mha.forward`` and ``flash_mha.backward`` ranges, in %."""

from portbench.metrics import _count, _window

RANGES = ("flash_mha.forward", "flash_mha.backward")


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    n = len(ctx.items)
    return _window.roofline(ctx, n * _count.train_attention_flops(ctx.cfg, ctx.batch, ctx.seq),
                            n * _count.train_attention_bytes(ctx.cfg, ctx.batch, ctx.seq),
                            ctx.trace.device_s_under(RANGES))
