"""The peak of the device memory allocated in the run, read when the
window closes (``torch.cuda.max_memory_allocated``), in GiB."""


def read(ctx):
    return ctx.peak / 2**30 if ctx.peak else None
