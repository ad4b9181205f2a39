"""Cross-request lane coalescing: shared-batch dispatch mechanics
(PyTorch port of :mod:`repro.serve.coalesce`).

LazyPIM batches coherence work speculatively and rolls back only the
kernels that actually conflict; the serve layer treats queued requests the
same way.  Compatible admitted studies — same geometry bucket, same
signature spec, same mechanism set, same static lazy flags, i.e. the same
*dispatch context* — stack their per-lane (trace, hw, lazy) triples
into ONE batched engine dispatch, padded up to a small set of **blessed
pow2 lane widths** with all-sentinel masked lanes
(:func:`repro_torch.sim.prep.dummy_trace`), and the stacked accumulators
split back per request by lane slice
(:meth:`repro_torch.sim.study.Study.points_from_lane_accs`).

In the reference, blessed widths bound the compile keys (lane count is a
compiled shape).  The port compiles nothing, but keeps the same widths:
the warm manifest rows (:func:`group_warm_entries`) and the dispatch
shapes stay the reference's, and on the card each width is one shape of
the Bloom kernels' grids (lanes are a grid axis), 1 to 64 lanes.

Fault isolation lives in the server (:mod:`repro_torch.serve.server`): this
module is the pure mechanics — group keys, lane stacking, blessed-width
padding, deterministic audit sampling — with no I/O and no policy.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.coherence import LazyPIMConfig
from repro_torch.core.signatures import SignatureSpec
from repro_torch.serve.warm import _GEOMETRY_KEYS
from repro_torch.sim import engine as _engine
from repro_torch.sim._traceref import threefry2x32
from repro_torch.sim.costmodel import HWParams
from repro_torch.sim.prep import TraceTensors, bucket_shapes, dummy_trace, neutral_trace
from repro_torch.sim.study import Study

__all__ = [
    "BLESSED_LANE_WIDTHS", "GroupKey", "LaneSlice", "blessed_width",
    "group_key", "group_lanes", "stack_group", "group_warm_entries",
    "audit_sample",
]

# The only lane counts a coalesced dispatch runs at (the reference's).
# Pow2 spacing bounds pad waste at 2x; the cap matches the fleet's
# realistic queue depths.  Changing this tuple changes the warm manifest's
# rows — treat it like a schema.
BLESSED_LANE_WIDTHS = (1, 2, 4, 8, 16, 32, 64)


def blessed_width(n: int, devices: int = 1) -> int:
    """The smallest blessed lane width >= ``n`` that a ``devices``-wide
    lane mesh can shard (the dispatch width a ``n``-lane group pads to).
    Blessed widths stay the ONLY dispatch widths — mesh multiples are
    chosen *from* them, and since both are powers of two, any blessed
    width >= the mesh size is automatically a mesh multiple.  Groups wider
    than the largest blessed width are a caller bug — the server caps its
    lane budget first."""
    if n < 1:
        raise ValueError(f"blessed_width needs n >= 1, got {n}")
    if devices < 1:
        raise ValueError(f"blessed_width needs devices >= 1, got {devices}")
    for w in BLESSED_LANE_WIDTHS:
        if w >= n and w % devices == 0:
            return w
    raise ValueError(
        f"{n} lanes / {devices} devices exceeds the largest blessed width "
        f"{BLESSED_LANE_WIDTHS[-1]}; cap the group (and route to a pow2 "
        f"device subset) before padding")


@dataclasses.dataclass(frozen=True)
class GroupKey:
    """The coalescing compatibility key: two studies may share one batched
    dispatch iff their keys are equal — same padded bucket geometry
    (``shape``, the ``pad_trace`` kwargs), same signature spec, same
    mechanism tuple, same static lazy flags.  Everything else (hw points,
    traced lazy knobs, the traces themselves) is per-lane data."""

    shape: tuple[tuple[str, int], ...]
    spec: SignatureSpec
    mechanisms: tuple[str, ...]
    lazy_static: tuple[tuple[str, Any], ...]


@dataclasses.dataclass(frozen=True)
class LaneSlice:
    """One member request's lane range in a stacked group dispatch."""

    rid: int
    start: int
    stop: int

    @property
    def slice(self) -> slice:
        return slice(self.start, self.stop)

    @property
    def lanes(self) -> int:
        return self.stop - self.start


def group_key(study: Study) -> GroupKey | None:
    """The study's coalescing key, or ``None`` if it is uncoalescible:
    multi-bucket studies stay on the per-request path (their lane order is
    not point order, so slicing a shared lane axis per request would not
    be well-defined — and they are the rare heterogeneous-fleet shape)."""
    tts = study.traces()
    buckets = bucket_shapes(tts)
    if len(buckets) != 1:
        return None
    idx, shape = buckets[0]
    lazy0 = study.lazy_points()[0]
    return GroupKey(
        shape=tuple(sorted(shape.items())),
        spec=tts[idx[0]].spec,
        mechanisms=study.mechanisms,
        lazy_static=tuple((f, getattr(lazy0, f))
                          for f in _engine._LAZY_STATIC_FIELDS))


def group_lanes(
    members: list[tuple[int, Study]],
) -> tuple[list[TraceTensors], list[HWParams], list[LazyPIMConfig],
           list[LaneSlice]]:
    """Concatenate the members' padded per-lane triples in member order,
    returning the flat lanes plus each member's :class:`LaneSlice` — the
    inverse map used to split the stacked accumulators back per request."""
    traces: list[TraceTensors] = []
    hws: list[HWParams] = []
    lazys: list[LazyPIMConfig] = []
    slices: list[LaneSlice] = []
    for rid, study in members:
        (bl,) = study.bucket_lanes()
        start = len(traces)
        traces.extend(bl.traces)
        hws.extend(bl.hws)
        lazys.extend(bl.lazys)
        slices.append(LaneSlice(rid, start, len(traces)))
    return traces, hws, lazys, slices


def stack_group(key: GroupKey, members: list[tuple[int, Study]],
                devices: int = 1, device=None):
    """Build the stacked (trace, hw, lazy) records for one coalesced
    dispatch on ``device`` (``None``: the CUDA card; the members' studies
    live there): member lanes in member order, padded with all-sentinel
    masked lanes (:func:`repro_torch.sim.prep.dummy_trace` — zero
    contribution by the window-validity masking) up to the blessed width
    (the smallest one a ``devices``-wide lane mesh divides).  Returns
    ``(stt, shw, scfg, slices, width)``."""
    traces, hws, lazys, slices = group_lanes(members)
    width = blessed_width(len(traces), devices)
    pad = width - len(traces)
    if pad:
        shape = dict(key.shape)
        dt = dummy_trace(key.spec, **shape, device=device)
        traces = traces + [dt] * pad
        hws = hws + [HWParams()] * pad
        lazys = lazys + [LazyPIMConfig(**dict(key.lazy_static))] * pad
    dev = traces[0].device
    stt = neutral_trace(_engine.stack_traces(traces))
    shw = _engine.stack_hw(hws, dev)
    scfg = _engine.stack_lazy(lazys, dev)
    return stt, shw, scfg, slices, width


def group_warm_entries(key: GroupKey, width: int,
                       devices: int = 1) -> list[dict]:
    """Warm-manifest rows for one coalesced dispatch — identical format to
    :func:`repro_torch.serve.warm.study_warm_entries`, with the *blessed*
    lane width as the lane count and the lane-mesh size the dispatch ran
    on, so restart replay launches what coalesced traffic launches."""
    shape = dict(key.shape)
    return [{
        **{k: int(shape[k]) for k in _GEOMETRY_KEYS},
        "mechanism": m,
        "lanes": int(width),
        "devices": int(devices),
        "spec": dataclasses.asdict(key.spec),
        "lazy_static": dict(key.lazy_static),
    } for m in key.mechanisms]


_AUDIT_SALT = np.uint32(0xAD17)


def audit_sample(seed: int, tag: int, lanes: int, fraction: float) -> list[int]:
    """A deterministic Threefry sample of lane indices to spot-check
    against the sequential reference: ``ceil(lanes * fraction)`` lanes,
    chosen by counter-based draws so one (seed, dispatch tag) replays one
    exact audit set on any machine.

    The sample is FLOORED AT ONE lane whenever ``fraction > 0`` and the
    sub-batch is non-empty: a plain ``int(lanes * fraction)`` truncation
    would round a <= 3-lane sub-batch at the default ``fraction=0.25``
    down to *zero* audited lanes, shipping small coalesced groups (and
    every post-bisection sub-batch) entirely unaudited — pinned by
    ``tests/test_torch_policy.py::test_audit_sample_floors_at_one_lane``."""
    if fraction <= 0.0 or lanes < 1:
        return []
    k = min(lanes, max(1, int(np.ceil(lanes * float(fraction)))))
    # One vectorized Threefry call over the lane counter axis —
    # elementwise, so bit-identical to per-lane scalar draws.
    x0, _ = threefry2x32(np.uint32(seed & 0xFFFFFFFF),
                         _AUDIT_SALT ^ np.uint32(tag & 0xFFFFFFFF),
                         np.arange(lanes, dtype=np.uint32),
                         np.full(lanes, _AUDIT_SALT, dtype=np.uint32))
    scores = [(int(s), i) for i, s in enumerate(np.asarray(x0))]
    return sorted(i for _, i in sorted(scores)[:k])
