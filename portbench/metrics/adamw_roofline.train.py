"""AdamW's share of its roofline in training, in %: the least time for the
update's bytes over the device time of the operations launched under the
program's ``adamw.step`` span.

Frozen count: for each parameter element, the parameter read and written
and its gradient read twice (the global norm and the update), at the
leaf's dtype, and both float32 moments (the harness's) read and written.
The arithmetic is not counted: the update is bound by its bytes.
"""

import math

from portbench import weights
from portbench.metrics import _spans, _window

RANGES = ("adamw.step",)
MOMENT_BYTES = 4


def update_bytes(cfg: dict) -> float:
    return float(sum(math.prod(shape) * (4 * dtype.itemsize + 4 * MOMENT_BYTES)
                     for shape, dtype, *_ in weights.leaf_specs(cfg).values()))


def read(ctx):
    if ctx.kind != "train":
        return None
    ms = _spans.device_ms_per_item(ctx, RANGES)
    if ms is None:
        return None
    return _window.roofline(ctx, 0.0, update_bytes(ctx.cfg), ms / 1e3)
