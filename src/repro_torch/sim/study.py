"""Declarative ``Study`` experiment API with an automatic execution planner
(PyTorch port of :mod:`repro.sim.study`).

    from repro_torch.api import Study, grid

    study = Study(workloads=["pagerank-arxiv", "htap128"],
                  hw=grid(offchip_bw_gbs=[16.0, 32.0, 64.0]),
                  mechanisms=("cpu", "cg", "lazypim"))
    print(study.plan().describe())   # buckets and lanes, before running
    results = study.run()            # ResultSet of tagged SimResults

``run()`` prepares the workloads on the study's device (``device=None`` is
the CUDA card), groups them into pow2-ish geometry buckets, folds the hw /
lazy axes into the stacked lane axis, and runs one lane-batched window
loop per (mechanism, bucket).  ``run(engine="sequential")`` runs every
point alone; the two are bit-exact on every ``SimResult`` field.  The
bucket and lane plan is the reference's, and ``ResultSet`` JSON files use
the reference's schema (version 1), so each package loads the other's.

Axes: ``workloads=`` (names, ``(app, graph)`` pairs, :func:`workload`
specs or prepared ``TraceTensors``), ``hw=`` (one ``HWParams``, a
:func:`grid`, or a per-workload list), ``mechanisms=``, ``lazy=`` (one
``LazyPIMConfig`` or a list varying only the numeric knobs).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import pathlib
from typing import Any, Iterable, Sequence

from repro_torch.core.coherence import LazyPIMConfig
from repro_torch.core.mechanisms import SimResult, finalize_result
from repro_torch.core.signatures import SignatureSpec
from repro_torch.device import resolve_device, same_device
from repro_torch.sim import engine as _engine
from repro_torch.sim import mesh as _mesh
from repro_torch.sim.costmodel import HWParams
from repro_torch.sim.prep import (TraceTensors, bucket_shapes, dummy_lane_triple, pad_trace,
                                  prepare)
from repro_torch.sim.trace import (ALL_APPS, GRAPH_INPUTS, check_app, is_known_app,
                                   make_trace)

__all__ = [
    "Study", "StudyPlan", "StudyPoint", "ResultSet", "ResultSetSchemaError",
    "Workload", "workload", "HWGrid", "grid", "Dispatch", "BucketLanes",
    "RESULTSET_SCHEMA_VERSION",
]

RESULTSET_SCHEMA_VERSION = 1


class ResultSetSchemaError(ValueError):
    """A persisted ResultSet artifact is truncated, corrupt, or from an
    incompatible schema version."""


@dataclasses.dataclass(frozen=True)
class Dispatch:
    """One engine dispatch unit, handed to a ``Study.run(on_dispatch=...)``
    boundary just before it executes."""

    engine: str                      # "batch" | "sequential"
    mechanism: str
    lanes: int = 1                   # stacked lanes in this dispatch
    bucket_lines: int | None = None  # batch only: the bucket's line bound
    workload: str | None = None      # sequential only: the point's workload
    devices: int = 1                 # lane-mesh size this dispatch shards over


# ---------------------------------------------------------------------------
# Workload / hardware axis specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Workload:
    """One workload entry: (app, graph input) plus optional per-entry
    overrides.  Build with :func:`workload`."""

    app: str
    graph: str | None = None
    threads: int | None = None
    spec: SignatureSpec | None = None
    trace_kw: tuple[tuple[str, Any], ...] = ()


def workload(app: str, graph: str | None = None, *,
             threads: int | None = None, spec: SignatureSpec | None = None,
             **trace_kw) -> Workload:
    """Workload spec with per-entry overrides, e.g.
    ``workload("pagerank", "arxiv", threads=4)``."""
    return Workload(app, graph, threads=threads, spec=spec,
                    trace_kw=tuple(sorted(trace_kw.items())))


@dataclasses.dataclass(frozen=True)
class HWGrid:
    """A hardware cross-product axis (build with :func:`grid`)."""

    base: HWParams
    axes: tuple[tuple[str, tuple[Any, ...]], ...]

    def points(self) -> list[HWParams]:
        names = [k for k, _ in self.axes]
        return [dataclasses.replace(self.base, **dict(zip(names, combo)))
                for combo in itertools.product(*(v for _, v in self.axes))]

    def labels(self) -> list[dict[str, Any]]:
        names = [k for k, _ in self.axes]
        return [dict(zip(names, combo))
                for combo in itertools.product(*(v for _, v in self.axes))]


def grid(base: HWParams | None = None, **axes: Iterable[Any]) -> HWGrid:
    """Hardware cross-product helper: ``grid(offchip_bw_gbs=[16, 32, 64])``;
    points enumerate in keyword order with the last axis fastest."""
    known = {f.name for f in dataclasses.fields(HWParams)}
    for name in axes:
        if name not in known:
            raise ValueError(f"grid: unknown HWParams field {name!r} "
                             f"(know {sorted(known)})")
    if not axes:
        raise ValueError("grid needs at least one HWParams field axis")
    return HWGrid(base or HWParams(),
                  tuple((k, tuple(v)) for k, v in axes.items()))


def _parse_workload(entry, i: int) -> Workload | TraceTensors:
    """Normalize one ``workloads=`` entry; ValueError names the entry."""
    if isinstance(entry, TraceTensors):
        return entry
    if isinstance(entry, Workload):
        app, graph = entry.app, entry.graph
    elif isinstance(entry, str):
        if entry in ALL_APPS or entry.startswith("capture/"):
            app, graph = entry, None
        else:
            app, _, graph = entry.rpartition("-")
            if not app:
                app, graph = entry, None
            if not is_known_app(app):
                raise ValueError(
                    f"workloads[{i}]: unknown workload {entry!r}: unknown app "
                    f"{app!r} (want '<app>' or '<app>-<graph>' with app in "
                    f"{sorted(ALL_APPS)} and graph in {GRAPH_INPUTS})")
        entry = Workload(app, graph)
    elif isinstance(entry, (tuple, list)) and len(entry) == 2:
        app, graph = entry
        entry = Workload(app, graph)
    else:
        raise ValueError(
            f"workloads[{i}]: cannot interpret {entry!r} as a workload "
            f"(want a name, an (app, graph) pair, a workload() spec, or "
            f"prepared TraceTensors)")
    try:
        check_app(app)
    except ValueError as e:
        raise ValueError(f"workloads[{i}]: {e}") from None
    if ALL_APPS[app] and graph not in GRAPH_INPUTS:
        raise ValueError(f"workloads[{i}]: app {app!r} needs a graph input "
                         f"from {GRAPH_INPUTS}, got {graph!r}")
    if not ALL_APPS[app] and graph is not None:
        raise ValueError(f"workloads[{i}]: app {app!r} is a table workload; "
                         f"graph must be None, got {graph!r}")
    return entry


# ---------------------------------------------------------------------------
# Results container
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StudyPoint:
    """One evaluated (workload, hw-point, lazy-point) coordinate."""

    workload: str
    hw_index: int
    lazy_index: int
    hw: HWParams
    lazy: LazyPIMConfig
    results: dict[str, SimResult]


_RATIO_KEYS = ("speedup", "traffic", "energy")


class ResultSet:
    """Tagged study results: one :class:`StudyPoint` per coordinate, in
    workload-major order."""

    def __init__(self, points: Sequence[StudyPoint],
                 mechanisms: Sequence[str]):
        self.points = list(points)
        self.mechanisms = tuple(mechanisms)

    def __len__(self) -> int:
        return len(self.points)

    def __iter__(self):
        return iter(self.points)

    @classmethod
    def concat(cls, sets: Sequence["ResultSet"]) -> "ResultSet":
        points = [p for rs in sets for p in rs.points]
        mechanisms = tuple(dict.fromkeys(m for rs in sets
                                         for m in rs.mechanisms))
        return cls(points, mechanisms)

    def normalized(self, to: str = "cpu") -> list[dict[str, dict]]:
        """Per-point summaries normalized to the ``to`` baseline of the same
        point (the paper's CPU-only presentation)."""
        for i, p in enumerate(self.points):
            if to not in p.results:
                raise ValueError(
                    f"normalized(to={to!r}) needs {to!r} in every point's "
                    f"mechanisms; points[{i}] ({p.workload}) only has "
                    f"{tuple(p.results)}")
        return [_engine.summarize(p.results, p.hw, to=to)
                for p in self.points]

    def to_rows(self) -> list[dict[str, Any]]:
        """One dict per (point, mechanism): coordinates, every SimResult
        field, the conflict rates and, with a ``cpu`` baseline, the ratios."""
        rows = []
        for p in self.points:
            norm = (_engine.summarize(p.results, p.hw)
                    if "cpu" in p.results else None)
            for m, r in p.results.items():
                row = dict(workload=p.workload, hw_index=p.hw_index,
                           lazy_index=p.lazy_index, mechanism=m)
                d = dataclasses.asdict(r)
                d.pop("name"), d.pop("mechanism")
                row.update(d)
                row["conflict_rate"] = r.conflict_rate
                row["conflict_rate_exact"] = r.conflict_rate_exact
                if norm is not None:
                    row.update({k: norm[m][k] for k in _RATIO_KEYS})
                rows.append(row)
        return rows

    def pivot(self, index: str | tuple[str, ...], columns: str,
              values: str) -> dict:
        """Spreadsheet pivot over :meth:`to_rows`; colliding cells raise."""
        out: dict = {}
        for row in self.to_rows():
            ik = (row[index] if isinstance(index, str)
                  else tuple(row[k] for k in index))
            ck = row[columns]
            cell = out.setdefault(ik, {})
            if ck in cell:
                raise ValueError(
                    f"pivot({index!r}, {columns!r}): duplicate cell "
                    f"({ik!r}, {ck!r}) — add a distinguishing field to index")
            cell[ck] = row[values]
        return out

    def save_json(self, path: str | pathlib.Path) -> pathlib.Path:
        """Serialize the full result set in the reference's schema."""
        payload = {
            "schema_version": RESULTSET_SCHEMA_VERSION,
            "mechanisms": list(self.mechanisms),
            "points": [{
                "workload": p.workload,
                "hw_index": p.hw_index,
                "lazy_index": p.lazy_index,
                "hw": dataclasses.asdict(p.hw),
                "lazy": dataclasses.asdict(p.lazy),
                "results": {m: dataclasses.asdict(r)
                            for m, r in p.results.items()},
            } for p in self.points],
        }
        path = pathlib.Path(path)
        path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
        return path

    @classmethod
    def load_json(cls, path: str | pathlib.Path) -> "ResultSet":
        """Load a :meth:`save_json` artifact (either package's).  A truncated,
        corrupt, or version-incompatible file raises
        :class:`ResultSetSchemaError` naming the path and the reason."""
        path = pathlib.Path(path)
        try:
            payload = json.loads(path.read_text())
        except json.JSONDecodeError as e:
            raise ResultSetSchemaError(
                f"{path}: not valid JSON (truncated or corrupt): {e}") from e
        if not isinstance(payload, dict):
            raise ResultSetSchemaError(
                f"{path}: expected a JSON object, got {type(payload).__name__}")
        version = payload.get("schema_version", RESULTSET_SCHEMA_VERSION)
        if version != RESULTSET_SCHEMA_VERSION:
            raise ResultSetSchemaError(
                f"{path}: schema_version {version!r} unsupported (this "
                f"build reads version {RESULTSET_SCHEMA_VERSION})")
        try:
            points = [StudyPoint(
                workload=d["workload"], hw_index=d["hw_index"],
                lazy_index=d["lazy_index"], hw=HWParams(**d["hw"]),
                lazy=LazyPIMConfig(**d["lazy"]),
                results={m: SimResult(**r) for m, r in d["results"].items()},
            ) for d in payload["points"]]
            return cls(points, tuple(payload["mechanisms"]))
        except (KeyError, TypeError, AttributeError) as e:
            raise ResultSetSchemaError(
                f"{path}: malformed ResultSet payload "
                f"({type(e).__name__}: {e})") from e


@dataclasses.dataclass
class BucketLanes:
    """One geometry bucket's stacked execution unit: the pad-target
    ``shape``, the study point indices riding it (lane ``i`` IS point
    ``lane_points[i]``) and the per-lane padded trace / hw / lazy triples."""

    shape: dict[str, int]
    lane_points: list[int]
    traces: list[TraceTensors]
    hws: list[HWParams]
    lazys: list[LazyPIMConfig]


# ---------------------------------------------------------------------------
# Execution plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StudyPlan:
    """The planner's predicted execution shape: geometry buckets with their
    lane counts, computed before anything runs, and the budget of dispatch
    shapes (the reference's compile budget): at most one new shape per
    (mechanism, bucket).  The port runs eagerly and compiles nothing; what
    it counts against the budget is
    :func:`repro_torch.sim.engine.sweep_cache_sizes`."""

    buckets: tuple[dict, ...]
    mechanisms: tuple[str, ...]
    num_points: int
    devices: int = 1

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    @property
    def dispatches(self) -> int:
        """Batched dispatches :meth:`Study.run` makes: one per (mechanism,
        bucket)."""
        return len(self.mechanisms) * self.num_buckets

    @property
    def compiles_per_mechanism(self) -> dict[str, int]:
        """Predicted new dispatch shapes per mechanism in a fresh process:
        one per geometry bucket, whatever ``devices`` is (each bucket runs
        once, at its routed mesh width, and ``sweep_cache_sizes`` sums
        every width).  Shapes seen before can only lower the measured
        ``sweep_cache_sizes`` delta."""
        return {m: self.num_buckets for m in self.mechanisms}

    @property
    def total_compiles(self) -> int:
        return len(self.mechanisms) * self.num_buckets

    def describe(self) -> str:
        lines = [f"{self.num_points} points x {len(self.mechanisms)} "
                 f"mechanisms in {self.num_buckets} geometry buckets "
                 f"(<= {self.total_compiles} dispatch shapes; eager PyTorch, "
                 f"nothing is compiled)"]
        if self.devices > 1:
            lines[0] += f", lane mesh over {self.devices} devices"
        for b in self.buckets:
            lines.append(
                f"  bucket {b['num_lines']} lines x {b['num_windows']} "
                f"windows: {b['lanes']} lanes over {len(b['workloads'])} "
                f"workloads, pad overhead {b['line_pad_overhead']:.2f}x")
            if b.get("devices", 1) > 1:
                lines[-1] += (f", sharded {b['padded_lanes']} lanes / "
                              f"{b['devices']} devices")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# The study itself
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Study:
    """Declarative experiment spec (see the module docstring).  ``device``
    is where traces are prepared and every dispatch runs: ``None`` means
    the CUDA card, and without one construction raises ``RuntimeError``
    unless ``device="cpu"`` is given."""

    workloads: Sequence
    hw: HWParams | HWGrid | Sequence[HWParams] | None = None
    mechanisms: Sequence[str] = _engine.MECHANISMS
    lazy: LazyPIMConfig | Sequence[LazyPIMConfig] | None = None
    threads: int = 16
    spec: SignatureSpec | None = None
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if not self.workloads:
            raise ValueError("a study needs at least one workload")
        self._entries = [_parse_workload(e, i)
                         for i, e in enumerate(self.workloads)]
        for i, e in enumerate(self._entries):
            if isinstance(e, TraceTensors) and not same_device(
                    e.window_valid, self.device):
                raise ValueError(f"workloads[{i}]: trace {e.name!r} lives on "
                                 f"{e.device}, the study on {self.device}")
        self.mechanisms = tuple(self.mechanisms)
        for i, m in enumerate(self.mechanisms):
            if m not in _engine.MECHANISMS:
                raise ValueError(f"mechanisms[{i}]: unknown mechanism {m!r} "
                                 f"(know {_engine.MECHANISMS})")
        if not self.mechanisms:
            raise ValueError("a study needs at least one mechanism")
        if isinstance(self.hw, (HWParams, HWGrid)) or self.hw is None:
            self._hws, self._zipped = None, False
        else:
            self._hws = list(self.hw)
            self._zipped = True
            if len(self._hws) != len(self._entries):
                raise ValueError(
                    f"hw list length {len(self._hws)} != "
                    f"{len(self._entries)} workloads (an explicit hw list "
                    f"is zipped per-workload; use grid(...) for a "
                    f"cross-product)")
            for i, h in enumerate(self._hws):
                if not isinstance(h, HWParams):
                    raise ValueError(f"hw[{i}]: expected HWParams, got "
                                     f"{type(h).__name__}")
        lazys = ([self.lazy] if isinstance(self.lazy, LazyPIMConfig)
                 else [LazyPIMConfig()] if self.lazy is None
                 else list(self.lazy))
        if not lazys:
            raise ValueError("lazy list must not be empty")
        for i, c in enumerate(lazys):
            if not isinstance(c, LazyPIMConfig):
                raise ValueError(f"lazy[{i}]: expected LazyPIMConfig, got "
                                 f"{type(c).__name__}")
            for f in _engine._LAZY_STATIC_FIELDS:
                if getattr(c, f) != getattr(lazys[0], f):
                    raise ValueError(
                        f"lazy[{i}]: static flag {f}={getattr(c, f)!r} "
                        f"differs from lazy[0] ({getattr(lazys[0], f)!r}); "
                        f"static flags select a different dataflow — run one "
                        f"study per static combo and ResultSet.concat the "
                        f"results")
        self._lazys = lazys
        self._tts: list[TraceTensors] | None = None
        self._bls: list[BucketLanes] | None = None

    # -- axis materialization ----------------------------------------------

    def traces(self) -> list[TraceTensors]:
        """Prepared TraceTensors of the workload axis (cached)."""
        if self._tts is None:
            tts = []
            for e in self._entries:
                if isinstance(e, TraceTensors):
                    tts.append(e)
                    continue
                trace = make_trace(e.app, e.graph,
                                   threads=e.threads or self.threads,
                                   device=self.device, **dict(e.trace_kw))
                tts.append(prepare(trace, e.spec or self.spec,
                                   device=self.device))
            self._tts = tts
        return self._tts

    def hw_points(self) -> list[HWParams]:
        if self._zipped:
            return list(self._hws)
        if isinstance(self.hw, HWGrid):
            return self.hw.points()
        return [self.hw or HWParams()]

    def lazy_points(self) -> list[LazyPIMConfig]:
        return list(self._lazys)

    @property
    def num_points(self) -> int:
        """Total (workload, hw, lazy) points, without generating a trace."""
        return len(self._lanes())

    def _lanes(self) -> list[tuple[int, int, int]]:
        """(workload, hw, lazy) index triples in point order: workload-major,
        then hw, then lazy; a zipped hw list pins hw index == workload."""
        W, L = len(self._entries), len(self._lazys)
        if self._zipped:
            return [(w, w, li) for w in range(W) for li in range(L)]
        H = len(self.hw_points())
        return [(w, h, li) for w in range(W) for h in range(H)
                for li in range(L)]

    # -- planning -----------------------------------------------------------

    def plan(self, devices: int | None = None) -> StudyPlan:
        """Predict the execution shape — geometry buckets and lane counts —
        without dispatching anything (the reference's bucket/lane plan).

        ``devices`` is the lane-mesh width :meth:`run` will shard over
        (``None`` = every visible device of the study's type, matching
        ``run``'s default); each bucket routes to the largest pow2 device
        subset its lane count fills (the bucket's ``devices`` entry) and
        pads its lane axis up to ``padded_lanes``, the next mesh multiple."""
        tts = self.traces()
        lanes = self._lanes()
        resolved = _mesh.resolve_devices(devices, self.device)
        buckets = []
        for idx, shape in bucket_shapes(tts):
            members = set(idx)
            sel = [lane for lane in lanes if lane[0] in members]
            real = sum(tts[w].num_lines for w, _, _ in sel)
            d = _mesh.devices_for(len(sel), resolved) if sel else 1
            buckets.append(dict(
                num_lines=shape["num_lines"],
                num_windows=shape["num_windows"],
                num_kernels=shape["num_kernels"],
                workloads=[tts[i].name for i in idx],
                lanes=len(sel),
                devices=d,
                padded_lanes=_mesh.mesh_lane_width(len(sel), d) if sel else 0,
                line_pad_overhead=shape["num_lines"] * len(sel) / max(real, 1),
            ))
        return StudyPlan(buckets=tuple(buckets), mechanisms=self.mechanisms,
                         num_points=len(lanes), devices=resolved)

    def bucket_lanes(self) -> list[BucketLanes]:
        """One :class:`BucketLanes` per geometry bucket, each with its padded
        per-lane trace / hw / lazy triples in point order (cached)."""
        if self._bls is None:
            tts, hws = self.traces(), self.hw_points()
            lazys, lanes = self.lazy_points(), self._lanes()
            out = []
            for idx, shape in bucket_shapes(tts):
                members = set(idx)
                sel = [j for j, lane in enumerate(lanes)
                       if lane[0] in members]
                if not sel:
                    continue
                padded = {w: pad_trace(tts[w], **shape) for w in idx}
                out.append(BucketLanes(
                    shape=shape, lane_points=sel,
                    traces=[padded[lanes[j][0]] for j in sel],
                    hws=[hws[lanes[j][1]] for j in sel],
                    lazys=[lazys[lanes[j][2]] for j in sel]))
            self._bls = out
        return self._bls

    def _make_point(self, j: int, results: dict[str, SimResult]) -> StudyPoint:
        tts, hws, lazys = self.traces(), self.hw_points(), self.lazy_points()
        w, h, li = self._lanes()[j]
        return StudyPoint(workload=tts[w].name, hw_index=h, lazy_index=li,
                          hw=hws[h], lazy=lazys[li], results=results)

    def points_from_lane_accs(self, accs: dict[str, dict]) -> ResultSet:
        """Split stacked accumulators back into this study's tagged points:
        ``accs`` maps mechanism -> host accumulator dict whose arrays carry
        a leading lane axis of length ``num_points``, ordered like the
        single bucket's ``lane_points``.  The result-splitting half of
        cross-request coalescing (:mod:`repro_torch.serve.coalesce`); only
        valid for single-bucket studies, where lane order is point order.
        Every lane passes the ``finalize_result`` integrity sentinel; a
        poisoned lane raises ``ResultIntegrityError`` naming the workload,
        mechanism and field."""
        bls = self.bucket_lanes()
        if len(bls) != 1:
            raise ValueError(
                f"points_from_lane_accs needs a single-bucket study, this "
                f"one has {len(bls)} buckets (serve such studies "
                f"uncoalesced)")
        points = []
        for pos, j in enumerate(bls[0].lane_points):
            w = self._lanes()[j][0]
            res = {m: finalize_result(self.traces()[w].name, m,
                                      {k: v[pos] for k, v in acc.items()})
                   for m, acc in accs.items()}
            points.append(self._make_point(j, res))
        return ResultSet(points, self.mechanisms)

    # -- execution ----------------------------------------------------------

    def run(self, engine: str = "batch", on_dispatch=None,
            devices: int | None = None, device=None) -> ResultSet:
        """Execute the study.

        ``engine="batch"`` runs the planner: one lane-batched dispatch per
        (mechanism, bucket).  ``engine="sequential"`` runs every point alone
        through :func:`repro_torch.sim.engine.run_mechanism`; the two are
        bit-exact.  ``device`` defaults to the study's own device; another
        device is a ``ValueError`` (build the study there instead).

        ``devices`` shards each bucket's stacked lane axis over a lane mesh
        (``None`` = every visible device of the study's type; on one card,
        or on the CPU without ``MESH_ENV_VAR``, that is the single-device
        path).  Buckets route per :meth:`plan`: the largest pow2 device
        subset their lanes fill, the lane axis padded to the mesh multiple
        with all-sentinel masked lanes that contribute nothing.  Sharded
        results equal ``devices=1`` bit for bit on every ``SimResult``
        field.  Batch engine only: ``engine="sequential"`` with
        ``devices > 1`` is a ``ValueError``.

        ``on_dispatch(dispatch_info, thunk)`` is an optional per-dispatch
        boundary, called once per (mechanism, bucket) in the batched engine
        and per (point, mechanism) in the sequential one; it must return the
        thunk's result unchanged or raise, which cancels the study."""
        if device is not None and resolve_device(device) != self.device:
            raise ValueError(f"this study was built on {self.device}; build "
                             f"a Study with device={str(device)!r} to run "
                             f"there")
        if engine == "batch":
            return self._run_batched(on_dispatch, devices=devices)
        if engine == "sequential":
            if devices is not None and int(devices) != 1:
                raise ValueError(
                    f"engine='sequential' is the single-device reference "
                    f"path; devices={devices} only applies to engine='batch'")
            return self._run_sequential(on_dispatch)
        raise ValueError(f"unknown engine {engine!r} "
                         f"(want 'batch' or 'sequential')")

    def _run_sequential(self, on_dispatch=None) -> ResultSet:
        tts, hws, lazys = self.traces(), self.hw_points(), self.lazy_points()
        points = []
        for w, h, li in self._lanes():
            res = {}
            for m in self.mechanisms:
                def thunk(m=m, w=w, h=h, li=li):
                    return _engine.run_mechanism(tts[w], hws[h], m, lazys[li],
                                                 device=self.device)
                if on_dispatch is None:
                    res[m] = thunk()
                else:
                    res[m] = on_dispatch(
                        Dispatch(engine="sequential", mechanism=m,
                                 workload=tts[w].name), thunk)
            points.append(StudyPoint(workload=tts[w].name, hw_index=h,
                                     lazy_index=li, hw=hws[h], lazy=lazys[li],
                                     results=res))
        return ResultSet(points, self.mechanisms)

    def _run_batched(self, on_dispatch=None,
                     devices: int | None = None) -> ResultSet:
        tts, lanes = self.traces(), self._lanes()
        resolved = _mesh.resolve_devices(devices, self.device)
        points: list[StudyPoint | None] = [None] * len(lanes)
        for bl in self.bucket_lanes():
            n = len(bl.traces)
            d = _mesh.devices_for(n, resolved)
            width = _mesh.mesh_lane_width(n, d)
            traces, hws, lazys = bl.traces, bl.hws, bl.lazys
            if width > n:
                # Mesh pad lanes: all-sentinel masked traces (zero
                # contribution) carrying the study's static lazy flags.
                # Appended past lane_points, so the result loop below
                # never reads them.
                static = {f: getattr(self._lazys[0], f)
                          for f in _engine._LAZY_STATIC_FIELDS}
                pads = [dummy_lane_triple(traces[0].spec, bl.shape, static,
                                          device=self.device)
                        for _ in range(width - n)]
                traces = traces + [p[0] for p in pads]
                hws = hws + [p[1] for p in pads]
                lazys = lazys + [p[2] for p in pads]
            stacked = _engine.neutral_trace(_engine.stack_traces(traces))
            shw = _engine.stack_hw(hws, self.device)
            scfg = _engine.stack_lazy(lazys, self.device)
            boundary = None
            if on_dispatch is not None:
                def boundary(m, thunk, _shape=bl.shape, _n=n, _d=d):
                    return on_dispatch(
                        Dispatch(engine="batch", mechanism=m, lanes=_n,
                                 bucket_lines=_shape["num_lines"],
                                 devices=_d), thunk)
            accs = _engine._sweep_accs(stacked, shw, self.mechanisms, scfg,
                                       boundary=boundary, devices=d)
            for pos, j in enumerate(bl.lane_points):
                w = lanes[j][0]
                res = {m: finalize_result(tts[w].name, m,
                                          {k: v[pos] for k, v in acc.items()})
                       for m, acc in accs.items()}
                points[j] = self._make_point(j, res)
        return ResultSet(points, self.mechanisms)
