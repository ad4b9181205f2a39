"""The routed experts' share of their roofline in prefill, in %: the least
time for their useful work over the device time of the operations launched
under the program's ``moe.experts`` span.

Frozen count, from the configuration's keys: every layer computes, for each
of the B * S tokens' top-k picks, a SwiGLU expert of 6 * d * d_expert FLOP
(gate, up and down products; capacity padding and padded experts are not
counted), and reads the real experts' weights once, in the parameter dtype.
"""

import torch

from portbench.metrics import _count, _spans, _window

RANGES = ("moe.experts",)


def flops(cfg: dict, batch: int, seq: int) -> float:
    m = _count.dims(cfg)
    return 6.0 * m["d"] * m["d_expert"] * m["top_k"] * batch * seq * m["layers"]


def weight_bytes(cfg: dict) -> float:
    m = _count.dims(cfg)
    size = getattr(torch, cfg["run"]["param_dtype"]).itemsize
    return 3.0 * m["d"] * m["d_expert"] * m["experts"] * size * m["layers"]


def read(ctx):
    if ctx.kind != "prefill" or not ctx.cfg.get("num_experts"):
        return None
    ms = _spans.device_ms_per_item(ctx, RANGES)
    if ms is None:
        return None
    return _window.roofline(ctx, flops(ctx.cfg, ctx.batch, ctx.seq), weight_bytes(ctx.cfg),
                            ms / 1e3)
