"""Workload traces (PyTorch port of :mod:`repro.sim.trace`).

A trace is a sequence of partial-kernel windows (<= 250 signature
insertions per set, §5.4): per window the cache-line addresses touched by
the PIM kernel and by the concurrently running processor threads, the
instruction counts, and a per-kernel pre-write line set for the
inter-kernel processor phase.  :func:`make_trace` synthesizes one on the
device (:mod:`repro_torch.sim.synth`), or with ``backend="ref"`` through
the sequential numpy reference (:mod:`repro_torch.sim._traceref`), the two
bit-identical; :func:`trace_from_numpy` builds one from the fields of any
other trace, e.g. one made by ``repro``, so both packages can simulate the
very same input.

Ported here: the Ligra graph apps and the HTAP IMDB (the paper's 12
workloads, Fig. 7), the extended families (BFS/SSSP frontier kernels,
streaming-ingest HTAP, the two-tenant mix: ``all_workloads(extended=True)``
is the reference's 22), and the captured traces ``capture/lazy_embed``
(recorded from the live LazySync protocol), ``capture/kv_serve`` (a
paged-KV decode loop) and ``capture/moe_experts`` (two tenants' live MoE
routing), all by :mod:`repro_torch.capture`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sim import synth
from repro_torch.sim.synth import AR, AW, BR, BW, MAX_SIG_ADDRS  # noqa: F401  (re-export)
from repro_torch.sim.synth import APP_CPU_WRITES  # noqa: F401  (re-export)

GRAPH_APPS = ("pagerank", "radii", "components")
GRAPH_INPUTS = ("enron", "arxiv", "gnutella")
HTAP_APPS = ("htap128", "htap192", "htap256")
FRONTIER_APPS = ("bfs", "sssp")
STREAM_APPS = ("htap_stream",)
MT_APPS = ("mtmix",)

# Recorded from live execution (repro_torch.capture), not synthesized.
CAPTURE_APPS = ("capture/kv_serve", "capture/moe_experts",
                "capture/lazy_embed")

# app -> needs a graph input?
ALL_APPS = {**{a: True for a in GRAPH_APPS + FRONTIER_APPS + MT_APPS},
            **{a: False for a in HTAP_APPS + STREAM_APPS + CAPTURE_APPS}}


def is_known_app(app: str) -> bool:
    """Whether ``app`` names a workload, or a capture spec (checked by
    :func:`check_app`)."""
    return app in ALL_APPS or app.startswith("capture/")


def check_app(app: str) -> None:
    """Raise a ``ValueError`` for an app no family or adapter produces."""
    if app in ALL_APPS:
        return
    if app.startswith("capture/"):
        raise ValueError(f"unknown capture spec {app!r} (know "
                         f"{sorted(CAPTURE_APPS)}); capture workloads are "
                         f"named 'capture/<adapter>'")
    raise ValueError(f"unknown app {app!r} (know {sorted(ALL_APPS)})")


@dataclasses.dataclass(frozen=True)
class WindowTrace:
    """Fixed-shape trace of W partial-kernel windows (tensors on one
    device)."""

    name: str
    threads: int
    num_lines: int
    pim_reads: torch.Tensor    # (W, AR) int32, -1 = empty slot
    pim_writes: torch.Tensor   # (W, AW) int32
    cpu_reads: torch.Tensor    # (W, BR) int32
    cpu_writes: torch.Tensor   # (W, BW) int32
    kernel_id: torch.Tensor    # (W,) int32
    kernel_start: torch.Tensor  # (W,) bool
    kernel_end: torch.Tensor   # (W,) bool
    pre_writes: torch.Tensor   # (K, num_lines) bool
    pim_instr: torch.Tensor    # (W,) float32
    cpu_instr: torch.Tensor    # (W,) float32
    cpu_priv_accesses: torch.Tensor  # (W,) float32
    cpu_priv_miss_rate: float
    cpu_reuse: float = 6.0

    @property
    def num_windows(self) -> int:
        return int(self.pim_reads.shape[0])

    @property
    def num_kernels(self) -> int:
        return int(self.pre_writes.shape[0])


_TENSOR_DTYPES = {
    "pim_reads": torch.int32, "pim_writes": torch.int32,
    "cpu_reads": torch.int32, "cpu_writes": torch.int32,
    "kernel_id": torch.int32, "kernel_start": torch.bool,
    "kernel_end": torch.bool, "pre_writes": torch.bool,
    "pim_instr": torch.float32, "cpu_instr": torch.float32,
    "cpu_priv_accesses": torch.float32,
}


def trace_from_numpy(fields: dict, device=None) -> WindowTrace:
    """Build a :class:`WindowTrace` on ``device`` from a dict of numpy
    arrays and scalars keyed by the WindowTrace field names (for example
    the fields of a ``repro`` trace), converting each array to its declared
    dtype."""
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(WindowTrace):
        if f.name not in fields:
            if f.default is dataclasses.MISSING:
                raise ValueError(f"trace_from_numpy: missing field {f.name!r}")
            continue
        v = fields[f.name]
        if f.name in _TENSOR_DTYPES:
            v = torch.from_numpy(np.array(v)).to(
                device=dev, dtype=_TENSOR_DTYPES[f.name])
        elif f.name == "name":
            v = str(v)
        elif f.name in ("threads", "num_lines"):
            v = int(v)
        elif f.name in ("cpu_priv_miss_rate", "cpu_reuse"):
            v = float(v)
        kw[f.name] = v
    return WindowTrace(**kw)


def build_plan(app: str, graph_name: str | None = None, threads: int = 16,
               num_kernels: int = 24, windows_per_kernel: int = 3,
               seed: int = 0, scale: float | None = None,
               cpu_reuse: float | None = None):
    """(plan, edges-or-None, display name) for any synthesized family, with
    the reference's per-family defaults (scale 0.01 for the table families,
    streaming's higher ``cpu_reuse``)."""
    if app.startswith("capture/"):
        raise ValueError(
            f"{app!r} is a captured workload: it is recorded from live "
            f"execution (repro_torch.capture), not synthesized — use "
            f"make_trace")
    check_app(app)
    if ALL_APPS[app] and graph_name not in GRAPH_INPUTS:
        raise ValueError(
            f"{app!r} needs a graph input from {GRAPH_INPUTS}, got {graph_name!r}")
    if not ALL_APPS[app] and graph_name is not None:
        raise ValueError(f"{app!r} is a table workload: graph_name must be "
                         f"None, got {graph_name!r}")
    if scale is None:
        scale = 0.01 if app in HTAP_APPS + STREAM_APPS else 1.0
    if cpu_reuse is None:
        cpu_reuse = 8.0 if app in STREAM_APPS else 6.0
    args = (threads, num_kernels, windows_per_kernel, seed, scale, cpu_reuse)
    if ALL_APPS[app]:
        build = (synth.build_graph_plan if app in GRAPH_APPS
                 else synth.build_frontier_plan if app in FRONTIER_APPS
                 else synth.build_mt_plan)
        plan, edges = build(app, graph_name, *args)
        return plan, edges, f"{app}-{graph_name}"
    build = synth.build_htap_plan if app in HTAP_APPS else synth.build_stream_plan
    return build(app, *args), None, app


BACKENDS = ("torch", "ref")


def make_trace(app: str, graph_name: str | None = None, threads: int = 16,
               seed: int = 0, num_kernels: int = 24,
               windows_per_kernel: int = 3, scale: float | None = None,
               cpu_reuse: float | None = None, device=None,
               backend: str = "torch") -> WindowTrace:
    """Synthesize a workload of any family, or record a captured one, on
    ``device`` (``None`` = the CUDA card; pass ``"cpu"`` for the CPU).
    Bit-identical with ``repro``'s ``make_trace`` for the same arguments.

    ``backend="torch"`` (the default; the port's name for the reference's
    ``"jax"``) generates the trace as tensor ops on ``device``;
    ``backend="ref"`` runs the sequential numpy reference
    (:mod:`repro_torch.sim._traceref`) and moves its arrays to ``device``.
    The two are bit-identical.  A captured workload is recorded the same
    way under either backend."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (know {BACKENDS})")
    dev = resolve_device(device)
    if app.startswith("capture/"):
        if graph_name is not None:
            raise ValueError(f"{app!r} is a captured workload: graph_name "
                             f"must be None, got {graph_name!r}")
        check_app(app)
        from repro_torch import capture

        return capture.capture_trace(
            app, threads=threads, seed=seed, num_kernels=num_kernels,
            windows_per_kernel=windows_per_kernel, scale=scale,
            cpu_reuse=cpu_reuse, device=dev)
    plan, edges, name = build_plan(app, graph_name, threads, num_kernels,
                                   windows_per_kernel, seed, scale, cpu_reuse)
    if backend == "ref":
        from repro_torch.sim import _traceref

        arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            device=dev, dtype=_TENSOR_DTYPES[k])
            for k, v in _traceref.synthesize_ref(plan, seed, edges).items()}
    else:
        arrays = synth.synthesize(plan, seed, edges, dev)
    return WindowTrace(name=name, threads=plan.threads,
                       num_lines=plan.total_lines,
                       cpu_priv_miss_rate=plan.cpu_priv_miss_rate,
                       cpu_reuse=plan.cpu_reuse, **arrays)


def make_graph_trace(app: str, graph_name: str, threads: int = 16, num_kernels: int = 24,
                     windows_per_kernel: int = 3, seed: int = 0, scale: float = 1.0,
                     cpu_reuse: float = 6.0, device=None,
                     backend: str = "torch") -> WindowTrace:
    """Trace for a Ligra graph app: :func:`make_trace` with the reference's
    defaults for this family (``device=None`` = the CUDA card)."""
    if app not in GRAPH_APPS:
        raise ValueError(f"{app!r} is not a graph app (know {GRAPH_APPS})")
    return make_trace(app, graph_name, threads=threads, seed=seed,
                      num_kernels=num_kernels, windows_per_kernel=windows_per_kernel,
                      scale=scale, cpu_reuse=cpu_reuse, device=device,
                      backend=backend)


def make_htap_trace(app: str = "htap128", threads: int = 16, num_kernels: int = 24,
                    windows_per_kernel: int = 3, seed: int = 0, scale: float = 0.01,
                    cpu_reuse: float = 6.0, device=None,
                    backend: str = "torch") -> WindowTrace:
    """Trace for the HTAP IMDB (§6.1): :func:`make_trace` with the
    reference's defaults for this family (``device=None`` = the CUDA card)."""
    if app not in HTAP_APPS:
        raise ValueError(f"{app!r} is not an HTAP app (know {HTAP_APPS})")
    return make_trace(app, None, threads=threads, seed=seed, num_kernels=num_kernels,
                      windows_per_kernel=windows_per_kernel, scale=scale,
                      cpu_reuse=cpu_reuse, device=device, backend=backend)


def all_workloads(extended: bool = False,
                  captured: bool = False) -> list[tuple[str, str | None]]:
    """The paper's 12 evaluated (app, input) pairs (Fig. 7); with
    ``extended=True`` also the extended families (the frontier kernels and
    the two-tenant mix on every graph input, streaming-ingest HTAP), the
    reference's 22; with ``captured=True``, also the live-model captured
    families (:mod:`repro_torch.capture`) — opt-in, so fig7-style fleets
    keep the paper-set means unchanged by default."""
    out: list[tuple[str, str | None]] = [
        (a, g) for a in GRAPH_APPS for g in GRAPH_INPUTS
    ]
    out += [(a, None) for a in HTAP_APPS]
    if extended:
        out += [(a, g) for a in FRONTIER_APPS for g in GRAPH_INPUTS]
        out += [(a, None) for a in STREAM_APPS]
        out += [(a, g) for a in MT_APPS for g in GRAPH_INPUTS]
    if captured:
        out += [(a, None) for a in CAPTURE_APPS]
    return out
