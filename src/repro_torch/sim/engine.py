"""Execution engines behind the ``Study`` planner (PyTorch port of
:mod:`repro.sim.engine`).

* **Sequential reference** — :func:`run_all` / :func:`run_mechanism` run
  one prepared trace through each mechanism's window loop.
* **Stacked dispatch** — :func:`run_sweep` runs a pre-stacked sweep: every
  tensor field of the trace / hardware / lazy-config records carries a
  leading lane axis (:func:`stack_traces` / :func:`stack_hw` /
  :func:`stack_lazy`) and one window loop per mechanism runs all lanes.
* **Bucketed fleet** — :func:`run_batch` groups a mixed-geometry fleet into
  padded geometry buckets through the ``Study`` planner.
* **Lane mesh** — ``_sweep_accs(..., devices=d)`` shards a stacked
  dispatch's lane axis over ``d`` devices (:mod:`repro_torch.sim.mesh`);
  ``devices=1`` is the single-device path, unchanged.

Both paths run the very same lane-batched window loop — the sequential
engine is the one-lane case — and both turn ``HWParams`` and the numeric
``LazyPIMConfig`` knobs into tensors at the declared dtypes the same way,
so batch and sequential agree bit for bit.

PyTorch runs eagerly, so the port has no jit cache.  What the reference's
cache counts — the distinct argument signatures a dispatch specialised on
— the port records itself (:func:`_dispatch_shape`), so
:func:`sweep_cache_sizes` and :func:`sequential_cache_sizes` give the
numbers the reference's compile budget is held to
(:attr:`repro_torch.sim.study.StudyPlan.compiles_per_mechanism`).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.coherence import LazyPIMConfig, _lazypim_acc
from repro_torch.core.mechanisms import ACC_FNS, SimResult, finalize_result
from repro_torch.core.signatures import SignatureSpec
from repro_torch.device import resolve_device, same_device
from repro_torch.sim import mesh as _mesh
from repro_torch.sim.costmodel import HWParams, hw_leaf_dtypes
from repro_torch.sim.prep import (
    TRACE_DATA_FIELDS,
    TRACE_META_FIELDS,
    TraceTensors,
    neutral_trace,
    prepare,
)
from repro_torch.sim.trace import make_trace

MECHANISMS = ("cpu", "fg", "cg", "nc", "lazypim", "ideal")


def _check_on(tt: TraceTensors, device) -> torch.device:
    """Resolve ``device`` (``None`` = the CUDA card) and require the trace
    to live there: a trace on another device is an error, never a silent
    CPU run."""
    dev = resolve_device(device)
    if not same_device(tt.window_valid, dev):
        raise ValueError(f"trace {tt.name!r} lives on {tt.device}, not on "
                         f"{dev}: prepare it with device={str(dev)!r}")
    return dev


# ---------------------------------------------------------------------------
# Stacking: the leading lane axis
# ---------------------------------------------------------------------------


def stack_hw(hws: list[HWParams], device) -> HWParams:
    """Stack HWParams into one record of (L,) tensors at the declared leaf
    dtypes (int32 counts/capacities, float32 everything else)."""
    dtypes = hw_leaf_dtypes()
    kw = {}
    for dt in (torch.float32, torch.int32):
        # one host-to-device copy per dtype, each field a row view of it
        names = [n for n, d in dtypes.items() if d == dt]
        rows = torch.tensor([[getattr(h, n) for h in hws] for n in names],
                            dtype=dt).to(device)
        kw.update(zip(names, rows))
    return HWParams(**kw)


_LAZY_DATA_DTYPES = {
    "use_dbi": torch.bool,
    "dbi_interval_cycles": torch.float32,
    "dbi_lines_per_fire": torch.int32,
    "commit_exposure": torch.float32,
}
_LAZY_STATIC_FIELDS = ("partial_commits", "cpuws_regs", "max_rollbacks")


def stack_lazy(cfgs: list[LazyPIMConfig], device) -> LazyPIMConfig:
    """Stack LazyPIMConfigs into one record of (L,) numeric tensors.  The
    static flags select a different dataflow, so a stack mixing them is a
    ``ValueError`` naming the offending entry."""
    c0 = cfgs[0]
    for i, c in enumerate(cfgs[1:], start=1):
        for f in _LAZY_STATIC_FIELDS:
            if getattr(c, f) != getattr(c0, f):
                raise ValueError(
                    f"lazy config [{i}] has static {f}={getattr(c, f)!r} != "
                    f"{getattr(c0, f)!r} of config [0]: static flags select "
                    f"a different dataflow and cannot share one stacked sweep")
    kw = {f: getattr(c0, f) for f in _LAZY_STATIC_FIELDS}
    for name, dt in _LAZY_DATA_DTYPES.items():
        kw[name] = torch.tensor([getattr(c, name) for c in cfgs], dtype=dt,
                                device=device)
    return LazyPIMConfig(**kw)


def stack_traces(tts: list[TraceTensors]) -> TraceTensors:
    """Stack same-geometry TraceTensors along a leading lane axis.  Mixed
    geometries are a ``ValueError`` (route them through :func:`run_batch`
    or a ``Study``, which pad them onto bucket shapes first)."""
    t0 = tts[0]
    for t in tts[1:]:
        same = (t.num_lines == t0.num_lines and t.num_windows == t0.num_windows
                and t.num_kernels == t0.num_kernels and t.spec == t0.spec
                and all(getattr(t, k).shape == getattr(t0, k).shape
                        for k in ("pim_reads", "pim_writes",
                                  "cpu_reads", "cpu_writes")))
        if not same:
            raise ValueError(f"cannot stack {t.name}: geometry differs from "
                             f"{t0.name} (run_batch buckets mixed fleets)")
    fields = {f.name: getattr(t0, f.name) for f in dataclasses.fields(t0)}
    for key in TRACE_DATA_FIELDS:
        fields[key] = torch.stack([getattr(t, key) for t in tts])
    return TraceTensors(**fields)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


# The dispatch shapes seen in this process, per mechanism: the batched
# dispatches' (every mesh width) and the sequential per-trace runs'.  Like
# the reference's jit caches they live as long as the process.
_SWEEP_SHAPES: dict[str, set] = {m: set() for m in MECHANISMS}
_SEQUENTIAL_SHAPES: dict[str, set] = {m: set() for m in MECHANISMS}


def _leaf_shapes(record, names) -> tuple:
    return tuple((n, tuple(getattr(record, n).shape), getattr(record, n).dtype)
                 for n in names)


def _dispatch_shape(mechanism: str, stt: TraceTensors, shw: HWParams,
                    scfg: LazyPIMConfig, devices: int) -> tuple:
    """The key the reference's jit specialises a dispatch on: the trace's
    metadata and every tensor field's shape and dtype, the hardware
    record's fields, the LazyPIM config's static flags and fields (its
    window loop alone takes the config) and the mesh width (the reference
    builds one jitted function per width)."""
    key = (tuple(getattr(stt, f) for f in TRACE_META_FIELDS),
           _leaf_shapes(stt, TRACE_DATA_FIELDS),
           _leaf_shapes(shw, tuple(hw_leaf_dtypes())), devices)
    if mechanism == "lazypim":
        key += (tuple(getattr(scfg, f) for f in _LAZY_STATIC_FIELDS),
                _leaf_shapes(scfg, tuple(_LAZY_DATA_DTYPES)))
    return key


def sweep_cache_sizes(mechanisms: tuple[str, ...] = MECHANISMS) -> dict[str, int]:
    """Distinct dispatch shapes per mechanism that the batched dispatches
    (``run_sweep``, ``run_batch``, the ``Study`` planner, the study
    service; every mesh width) have run in this process: the count the
    reference's ``sweep_cache_sizes`` reads from its jit caches.  Its delta
    across a run is what ``Study.plan().compiles_per_mechanism`` predicts."""
    return {m: len(_SWEEP_SHAPES[m]) for m in mechanisms}


def sequential_cache_sizes(
    mechanisms: tuple[str, ...] = MECHANISMS,
) -> dict[str, int]:
    """Distinct dispatch shapes per mechanism of the sequential per-trace
    runs behind :func:`run_all` / :func:`run_mechanism` in this process
    (one per distinct trace geometry, as the reference's per-trace jits)."""
    return {m: len(_SEQUENTIAL_SHAPES[m]) for m in mechanisms}


def _run_lanes(mechanism: str, stt: TraceTensors, shw: HWParams,
               scfg: LazyPIMConfig) -> dict:
    """One mechanism's window loop over every lane of a stacked trace."""
    if mechanism == "lazypim":
        return _lazypim_acc(stt, shw, scfg)
    return ACC_FNS[mechanism](stt, shw)


def _sweep_accs(stt: TraceTensors, shw: HWParams, mechanisms: tuple[str, ...],
                scfg: LazyPIMConfig, boundary=None, devices: int = 1,
                _shapes: dict[str, set] = _SWEEP_SHAPES) -> dict[str, dict]:
    """Run one stacked execution per mechanism and return host-side numpy
    accumulators with a leading lane axis — THE shared dispatch of every
    batched engine.  ``boundary`` is the per-dispatch error/cancellation
    boundary ``(mechanism, thunk) -> accs``; the thunk runs the dispatch and
    copies its results to the host, so device failures surface inside the
    boundary.  A boundary returns the thunk's result unchanged or raises.

    ``devices`` selects the mesh variant: the stacked lane axis shards over
    a ``devices``-wide lane mesh (:func:`repro_torch.sim.mesh.shard_lanes`;
    the lane count must already be a multiple of ``devices`` — the planner
    pads with :func:`repro_torch.sim.prep.dummy_lane_triple` lanes).
    ``devices=1`` runs the single-device dispatch itself: no shard call, no
    split, no copy.  Each dispatch that runs adds its
    :func:`_dispatch_shape` to ``_shapes`` (the sequential runs keep
    theirs apart)."""
    out = {}
    for m in mechanisms:
        run = functools.partial(_run_lanes, m)
        if devices > 1:
            run = _mesh.shard_lanes(run, devices, stt.device)

        def thunk(run=run, m=m):
            _shapes[m].add(_dispatch_shape(m, stt, shw, scfg, devices))
            return {k: v.cpu().numpy() for k, v in run(stt, shw, scfg).items()}

        out[m] = thunk() if boundary is None else boundary(m, thunk)
    return out


def run_mechanism(tt: TraceTensors, hw: HWParams, mechanism: str,
                  lazy_cfg: LazyPIMConfig | None = None,
                  device=None) -> SimResult:
    """One trace through one mechanism: the one-lane case of the stacked
    window loop, with the same tensor conversions as the batched path."""
    dev = _check_on(tt, device)
    acc = _sweep_accs(stack_traces([neutral_trace(tt)]), stack_hw([hw], dev),
                      (mechanism,), stack_lazy([lazy_cfg or LazyPIMConfig()], dev),
                      _shapes=_SEQUENTIAL_SHAPES)
    return finalize_result(tt.name, mechanism,
                           {k: v[0] for k, v in acc[mechanism].items()})


def run_all(tt: TraceTensors, hw: HWParams | None = None,
            mechanisms: tuple[str, ...] = MECHANISMS,
            lazy_cfg: LazyPIMConfig | None = None,
            device=None) -> dict[str, SimResult]:
    """Every mechanism on one prepared trace (sequential reference).
    ``device=None`` means the CUDA card; the trace must live on ``device``."""
    hw = hw or HWParams()
    return {m: run_mechanism(tt, hw, m, lazy_cfg, device) for m in mechanisms}


def run_sweep(tt: TraceTensors, hw: HWParams,
              mechanisms: tuple[str, ...] = MECHANISMS,
              lazy_cfg: LazyPIMConfig | None = None,
              device=None) -> list[dict[str, SimResult]]:
    """Every mechanism over a pre-stacked sweep: ``tt`` from
    :func:`stack_traces`, ``hw`` from :func:`stack_hw` (one lane per point);
    ``lazy_cfg`` is broadcast to every point.  Returns one
    ``{mechanism: SimResult}`` dict per point, bit-exact with per-point
    :func:`run_all`."""
    if not mechanisms:
        return []
    dev = _check_on(tt, device)
    lazy_cfg = lazy_cfg or LazyPIMConfig()
    num_points = tt.window_valid.shape[0]
    if hw.freq_ghz.shape[0] != num_points:
        raise ValueError(f"hw has {hw.freq_ghz.shape[0]} lanes, trace "
                         f"{num_points}")
    scfg = stack_lazy([lazy_cfg] * num_points, dev)
    accs = _sweep_accs(neutral_trace(tt), hw, mechanisms, scfg)
    return [{m: finalize_result(tt.name, m, {k: v[i] for k, v in acc.items()})
             for m, acc in accs.items()} for i in range(num_points)]


def run_batch(tts: list[TraceTensors],
              hw: HWParams | list[HWParams] | None = None,
              mechanisms: tuple[str, ...] = MECHANISMS,
              lazy_cfg: LazyPIMConfig | None = None,
              device=None) -> list[dict[str, SimResult]]:
    """A whole workload fleet in geometry buckets (through the ``Study``
    planner); results per input workload, in input order, bit-exact with
    sequential :func:`run_all`.  ``hw`` is one HWParams for the fleet or a
    list aligned with ``tts``."""
    from repro_torch.sim.study import Study

    if not tts:
        return []
    if hw is not None and not isinstance(hw, HWParams):
        hw = list(hw)
        if len(hw) != len(tts):
            raise ValueError(f"hw list length {len(hw)} != fleet size {len(tts)}")
    study = Study(workloads=tts, hw=hw, mechanisms=mechanisms, lazy=lazy_cfg,
                  device=device)
    return [p.results for p in study.run().points]


def summarize(results: dict[str, SimResult], hw: HWParams,
              to: str = "cpu") -> dict[str, dict]:
    """Normalize every mechanism to a baseline (the paper normalizes to
    CPU-only)."""
    base = results[to]
    base_e = base.energy_pj(hw)["total"]
    out = {}
    for m, r in results.items():
        out[m] = dict(
            speedup=base.time_ns / r.time_ns,
            traffic=r.offchip_bytes / base.offchip_bytes,
            energy=r.energy_pj(hw)["total"] / base_e,
            time_ns=r.time_ns,
            offchip_bytes=r.offchip_bytes,
            energy_pj=r.energy_pj(hw)["total"],
            conflict_rate=r.conflict_rate,
            conflict_rate_exact=r.conflict_rate_exact,
            flush_lines=r.flush_lines,
            blocked_accesses=r.blocked_accesses,
        )
    return out


def run_workload(app: str, graph_name: str | None = None, threads: int = 16,
                 hw: HWParams | None = None, spec: SignatureSpec | None = None,
                 mechanisms: tuple[str, ...] = MECHANISMS,
                 lazy_cfg: LazyPIMConfig | None = None, device=None,
                 **trace_kw) -> dict[str, SimResult]:
    """Convenience: trace -> prepare -> run_all on ``device``."""
    trace = make_trace(app, graph_name, threads=threads, device=device, **trace_kw)
    tt = prepare(trace, spec, device=device)
    return run_all(tt, hw or HWParams(), mechanisms, lazy_cfg, device=device)


__all__ = ["MECHANISMS", "run_mechanism", "run_all", "run_sweep", "run_batch",
           "run_workload", "summarize", "stack_hw", "stack_lazy",
           "stack_traces", "sweep_cache_sizes", "sequential_cache_sizes"]
