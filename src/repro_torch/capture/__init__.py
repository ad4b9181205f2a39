"""Coherence-trace capture from live execution, PyTorch port of
:mod:`repro.capture`.

Each adapter runs live code and records the integer index streams it
already computes as a :class:`repro_torch.sim.trace.WindowTrace`, through
the recorder (:mod:`.recorder`), the line-mapper (:mod:`.layout`) and the
windower.  The adapters: ``capture/lazy_embed``, which records the
LazySync protocol (:mod:`repro_torch.core.lazy_sync`),
``capture/kv_serve``, a paged-KV decode loop at the serving stack's
page/slot arithmetic, and ``capture/moe_experts``, two tenants' traffic
through the MoE block's live routing (:mod:`repro_torch.models.moe`).
"""

from __future__ import annotations

from repro_torch.capture.kv_serve import KVServeConfig, capture_kv_serve
from repro_torch.capture.lazy_embed import LazyEmbedConfig, capture_lazy_embed
from repro_torch.capture.layout import LineLayout, Region
from repro_torch.capture.moe_experts import MoEExpertsConfig, capture_moe_experts
from repro_torch.capture.recorder import WindowRecorder
from repro_torch.sim.trace import CAPTURE_APPS, WindowTrace

_ADAPTERS = {"capture/kv_serve": capture_kv_serve,
             "capture/moe_experts": capture_moe_experts,
             "capture/lazy_embed": capture_lazy_embed}
assert set(_ADAPTERS) == set(CAPTURE_APPS)

# Per-adapter cpu_reuse defaults (the reference's values: the KV hot tail
# is re-read hardest, like the streaming family).
_CPU_REUSE = {"capture/kv_serve": 8.0, "capture/moe_experts": 6.0,
              "capture/lazy_embed": 6.0}


def capture_trace(app: str, threads: int = 16, seed: int = 0,
                  num_kernels: int = 24, windows_per_kernel: int = 3,
                  scale: float | None = None, cpu_reuse: float | None = None,
                  device=None) -> WindowTrace:
    """``make_trace`` backend for ``capture/*`` apps, on ``device``
    (``None`` = the CUDA card)."""
    fn = _ADAPTERS.get(app)
    if fn is None:
        raise ValueError(
            f"unknown capture spec {app!r} (know {sorted(CAPTURE_APPS)}); "
            f"capture workloads are named 'capture/<adapter>'")
    return fn(threads=threads, seed=seed, num_kernels=num_kernels,
              windows_per_kernel=windows_per_kernel,
              scale=1.0 if scale is None else scale,
              cpu_reuse=_CPU_REUSE[app] if cpu_reuse is None else cpu_reuse,
              device=device)


__all__ = [
    "CAPTURE_APPS", "KVServeConfig", "LazyEmbedConfig", "LineLayout",
    "MoEExpertsConfig", "Region", "WindowRecorder", "capture_kv_serve",
    "capture_lazy_embed", "capture_moe_experts", "capture_trace",
]
