"""Request / response schema of the resident study service (PyTorch port
of :mod:`repro.serve.request`).

A request is a :class:`~repro_torch.sim.study.Study` — either the object itself
(in-process callers) or a JSON-able spec dict (the wire format, also what
the crash journal persists)::

    {"workloads": ["pagerank-arxiv", "htap128",
                   {"app": "htap128", "scale": 0.004}],
     "mechanisms": ["cpu", "cg", "lazypim"],
     "threads": 16,
     "hw_grid": {"offchip_bw_gbs": [16.0, 32.0]}}

``build_study`` maps a spec onto the ``Study`` constructor and nothing
else: every malformed spec fails with the planner's own ``ValueError``
naming the offending entry, *before* any trace is synthesized or any
window loop runs — the fuzz suite (``tests/test_torch_study_fuzz.py``)
holds that line.  The study is built on the server's device (``device=``;
``None`` is the CUDA card).

Every submitted request resolves to exactly one :class:`Response` with an
explicit terminal status — reject, timeout, served (possibly degraded /
after retries), or crash-then-recovered.  There is no silent outcome.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.device import resolve_device
from repro_torch.sim.study import ResultSet, Study, grid, workload

# Terminal request statuses.  Grouped by how the fault (if any) resolved.
OK = "ok"                                 # served by the batched planner
OK_DEGRADED = "ok_degraded"               # served by the sequential reference
REJECTED_MALFORMED = "rejected_malformed"  # spec invalid; named ValueError
REJECTED_OVERSIZED = "rejected_oversized"  # admission: lane bound exceeded
REJECTED_OVERLOAD = "rejected_overload"    # queue full; load shed
TIMEOUT = "timeout"                        # deadline passed / hang detected
CRASHED = "crashed"                        # worker crash; journaled for restart
FAILED = "failed"                          # retries + degradation exhausted
QUARANTINED = "quarantined"                # isolated as a coalescing poison

SERVED = frozenset({OK, OK_DEGRADED})
REJECTED = frozenset({REJECTED_MALFORMED, REJECTED_OVERSIZED,
                      REJECTED_OVERLOAD})
TERMINAL = SERVED | REJECTED | frozenset({TIMEOUT, FAILED, QUARANTINED})


@dataclasses.dataclass
class StudyRequest:
    rid: int
    study: Study
    spec: dict | None          # raw JSON-able spec, if given (journaled)
    deadline_s: float
    submitted_at: float        # server-clock time of admission
    attempts: int = 0

    def deadline(self) -> float:
        return self.submitted_at + self.deadline_s


@dataclasses.dataclass
class Response:
    """The single terminal answer to one submitted request."""

    rid: int
    status: str
    results: ResultSet | None = None
    engine: str | None = None   # "batch" | "sequential" (when served)
    attempts: int = 0           # batched attempts consumed
    error: str | None = None    # why rejected / degraded / failed
    latency_s: float = 0.0      # admission -> resolution, server clock
    restarted: bool = False     # answered by a post-crash recovery replay

    @property
    def served(self) -> bool:
        return self.status in SERVED


_SPEC_KEYS = ("workloads", "mechanisms", "threads", "hw_grid")
_WORKLOAD_KEYS = ("app", "graph", "threads")


def _parse_workload_entry(entry: Any, i: int):
    """A spec workload entry: a name, an [app, graph] pair, or an options
    dict whose extra keys are trace kwargs (scale, num_kernels, ...)."""
    if isinstance(entry, dict):
        if "app" not in entry:
            raise ValueError(
                f"workloads[{i}]: a workload dict needs an 'app' key, got "
                f"{sorted(entry)}")
        if not isinstance(entry["app"], str):
            raise ValueError(
                f"workloads[{i}]: 'app' must be a string, got "
                f"{entry['app']!r}")
        if "spec" in entry:
            raise ValueError(
                f"workloads[{i}]: per-entry signature specs are not "
                f"supported over the wire (not JSON-able); submit a Study "
                f"object in-process instead")
        trace_kw = {k: v for k, v in entry.items()
                    if k not in _WORKLOAD_KEYS}
        return workload(entry["app"], entry.get("graph"),
                        threads=entry.get("threads"), **trace_kw)
    if isinstance(entry, list):  # JSON has no tuples
        return tuple(entry)
    return entry


def build_study(spec: Study | dict, device=None) -> Study:
    """Spec -> validated ``Study`` on ``device`` (``None``: the CUDA card).
    All validation is the Study constructor's own (every bad entry raises a
    ``ValueError`` naming it); this function only maps the JSON shape onto
    the constructor.  A ``Study`` object is taken as it is if it was built
    on ``device``; one built elsewhere is a ``ValueError``."""
    if isinstance(spec, Study):
        if spec.device != resolve_device(device):
            raise ValueError(f"request study was built on {spec.device}, the "
                             f"server runs on {resolve_device(device)}")
        return spec
    if not isinstance(spec, dict):
        raise ValueError(
            f"request spec must be a Study or a dict, got "
            f"{type(spec).__name__}")
    unknown = sorted(set(spec) - set(_SPEC_KEYS))
    if unknown:
        raise ValueError(f"unknown request spec keys {unknown} "
                         f"(know {list(_SPEC_KEYS)})")
    if "workloads" not in spec:
        raise ValueError("request spec needs a 'workloads' list")
    kw: dict[str, Any] = {
        "workloads": [_parse_workload_entry(e, i)
                      for i, e in enumerate(spec["workloads"])],
    }
    if "mechanisms" in spec:
        kw["mechanisms"] = tuple(spec["mechanisms"])
    if "threads" in spec:
        if not isinstance(spec["threads"], int):
            raise ValueError(
                f"threads must be an int, got {spec['threads']!r}")
        kw["threads"] = spec["threads"]
    if "hw_grid" in spec:
        if not isinstance(spec["hw_grid"], dict) or not spec["hw_grid"]:
            raise ValueError(
                f"hw_grid must be a non-empty dict of HWParams field axes, "
                f"got {spec['hw_grid']!r}")
        kw["hw"] = grid(**spec["hw_grid"])
    return Study(**kw, device=device)
