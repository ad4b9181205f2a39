"""Crash-safe warm restart of the resident study service: the warm
manifest, and what "warm" means in the port (PyTorch port of
:mod:`repro.serve.warm`).

The reference warms two layers: XLA's persistent compilation cache, and a
manifest of the compile keys (mechanism, bucket geometry, lane count,
signature spec, static lazy flags) its served studies touched, replayed
at restart so that a repeat study compiles nothing.  The port compiles no
scans: PyTorch runs the window loops eagerly.  What a fresh process pays
before its first answer is

1. the ``nvcc`` build of each CUDA source it launches — content-addressed
   in the checkout's ``build/`` (:mod:`repro_torch.kernels._build`), so
   built once a machine and kept across processes;
2. binding each built library with ``ctypes`` — once a process;
3. loading each kernel's CUDA module on its first launch (and the CUDA
   context) — once a process.

So in the port, *warm* means: every library that a recorded dispatch
launches is built and bound, and every kernel it launches has run once in
this process.  :meth:`WarmCache.record` writes the very rows the reference
writes for the same served study (the same keys, schema version 1, the
same corrupt-file quarantine); :meth:`WarmCache.warm` replays each row
once through :func:`repro_torch.sim.engine._sweep_accs` on
:func:`dummy_stacked` — all-sentinel lanes of the row's exact geometry on
the server's device, so the replay launches what the row's dispatch
launches and can pollute no result.  A restarted server that warmed from
its manifest answers a repeat study with zero ``nvcc`` builds and zero new
library binds (:func:`repro_torch.kernels._build.build_counts`), the
port's form of the reference's zero-new-compiles check.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time

from repro_torch.core.coherence import LazyPIMConfig
from repro_torch.core.signatures import SignatureSpec
from repro_torch.kernels import _build
from repro_torch.sim import engine as _engine
from repro_torch.sim import mesh as _mesh
from repro_torch.sim.costmodel import HWParams
from repro_torch.sim.prep import bucket_shapes, dummy_trace
from repro_torch.sim.study import Study

MANIFEST_NAME = "warm_manifest.json"
MANIFEST_SCHEMA_VERSION = 1

_GEOMETRY_KEYS = ("num_lines", "num_windows", "num_kernels",
                  "pim_read_slots", "pim_write_slots",
                  "cpu_read_slots", "cpu_write_slots")
# Required row fields.  "devices" (the lane-mesh size the dispatch ran on)
# is written by every producer but not required: the reference's pre-mesh
# manifests load, defaulting to 1 device at replay.
_ENTRY_KEYS = frozenset((*_GEOMETRY_KEYS, "mechanism", "lanes", "spec",
                         "lazy_static"))


class ManifestCorruptError(ValueError):
    """The warm manifest on disk is truncated, corrupt, or from an
    incompatible schema version.  :meth:`WarmCache.load_manifest` raises
    this internally, then *quarantines* the bad file (renamed to
    ``warm_manifest.json.corrupt-N``) and rebuilds from empty — a torn
    write must cost the warm state, never wedge ``restart_server``."""


def enable_persistent_cache(cache_dir: str | pathlib.Path) -> bool:
    """Create ``cache_dir`` and report whether the port's persistent build
    state is complete: True iff the build directory
    (:data:`repro_torch.kernels._build.BUILD_DIR`, which this does not
    move) holds the current build of every ``csrc`` source.  The port has
    no compile cache to point at ``cache_dir``: the ``nvcc`` outputs are
    content-addressed in ``build/`` and shared by every process of the
    checkout; a missing one is built on the first launch that needs it (by
    :meth:`WarmCache.warm` at restart)."""
    pathlib.Path(cache_dir).mkdir(parents=True, exist_ok=True)
    return _build.all_built()


def study_warm_entries(study: Study, devices: int = 1) -> list[dict]:
    """The dispatch tuples a study's batched execution runs: one entry per
    (mechanism, geometry bucket) with the stacked lane count, the lane-mesh
    routing (``devices``, the lane count padded to its multiple) and the
    static context (signature spec, static lazy flags).  JSON-able — the
    manifest row format, equal to the reference's rows for the same
    study."""
    tts = study.traces()
    lanes = study._lanes()
    lazy0 = study.lazy_points()[0]
    static = {f: getattr(lazy0, f) for f in _engine._LAZY_STATIC_FIELDS}
    entries = []
    for idx, shape in bucket_shapes(tts):
        members = set(idx)
        n_lanes = sum(1 for lane in lanes if lane[0] in members)
        if not n_lanes:
            continue
        d = _mesh.devices_for(n_lanes, devices)
        spec = tts[idx[0]].spec
        for m in study.mechanisms:
            entries.append({
                **{k: int(shape[k]) for k in _GEOMETRY_KEYS},
                "mechanism": m,
                "lanes": int(_mesh.mesh_lane_width(n_lanes, d)),
                "devices": int(d),
                "spec": dataclasses.asdict(spec),
                "lazy_static": dict(static),
            })
    return entries


def _entry_key(e: dict) -> str:
    return json.dumps(e, sort_keys=True)


def dummy_stacked(entry: dict, device=None):
    """The (stacked trace, stacked hw, stacked lazy) triple of a manifest
    entry on ``device`` (``None``: the CUDA card): its exact bucket
    geometry and lane count, every lane the all-sentinel
    :func:`~repro_torch.sim.prep.dummy_trace`."""
    tt = dummy_trace(SignatureSpec(**entry["spec"]),
                     **{k: entry[k] for k in _GEOMETRY_KEYS}, device=device)
    lanes = entry["lanes"]
    stt = _engine.stack_traces([tt] * lanes)
    shw = _engine.stack_hw([HWParams()] * lanes, tt.device)
    scfg = _engine.stack_lazy(
        [LazyPIMConfig(**entry["lazy_static"])] * lanes, tt.device)
    return stt, shw, scfg


class WarmCache:
    """The server's crash-safe warm state: manifest bookkeeping + replay on
    ``device`` (``None``: the CUDA card)."""

    def __init__(self, cache_dir: str | pathlib.Path, device=None):
        self.dir = pathlib.Path(cache_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.device = device
        self.manifest_path = self.dir / MANIFEST_NAME
        self.persistent = enable_persistent_cache(self.dir)
        self.quarantined_manifests = 0  # corrupt files set aside, not read
        self.skipped_entries = 0        # mesh entries this host cannot replay
        self.warm_wall_s = 0.0          # host seconds of the last warm()

    def _parse_manifest(self, text: str) -> list[dict]:
        """Strict manifest parse; any deviation is a named
        :class:`ManifestCorruptError` (the caller quarantines)."""
        try:
            payload = json.loads(text)
        except json.JSONDecodeError as e:
            raise ManifestCorruptError(
                f"{self.manifest_path}: not valid JSON (truncated or "
                f"corrupt write): {e}") from e
        if not isinstance(payload, dict) or "entries" not in payload:
            raise ManifestCorruptError(
                f"{self.manifest_path}: expected an object with an "
                f"'entries' list")
        # Pre-stamp manifests (written before the schema_version field
        # existed) are the version-1 entry layout; a missing field loads.
        version = payload.get("schema_version", MANIFEST_SCHEMA_VERSION)
        if version != MANIFEST_SCHEMA_VERSION:
            raise ManifestCorruptError(
                f"{self.manifest_path}: schema_version {version!r} "
                f"unsupported (this build reads "
                f"{MANIFEST_SCHEMA_VERSION})")
        entries = payload["entries"]
        if not isinstance(entries, list) or not all(
                isinstance(e, dict) and _ENTRY_KEYS <= set(e)
                for e in entries):
            raise ManifestCorruptError(
                f"{self.manifest_path}: malformed entry rows (want "
                f"{sorted(_ENTRY_KEYS)} per entry)")
        return entries

    def load_manifest(self) -> list[dict]:
        """Manifest entries, or ``[]``.  A corrupt/truncated/incompatible
        manifest is *quarantined* — renamed to ``warm_manifest.json
        .corrupt-N`` for diagnosis — and the warm state rebuilds from
        empty; ``restart_server`` must never wedge on a torn write."""
        if not self.manifest_path.exists():
            return []
        try:
            return self._parse_manifest(self.manifest_path.read_text())
        except ManifestCorruptError:
            n = 0
            while (q := self.manifest_path.with_name(
                    f"{MANIFEST_NAME}.corrupt-{n}")).exists():
                n += 1
            self.manifest_path.replace(q)
            self.quarantined_manifests += 1
            return []

    def record(self, study: Study, devices: int = 1) -> int:
        """Merge a served study's dispatch tuples into the manifest
        (idempotent; crash-safe via atomic rename).  Returns the number of
        new entries."""
        return self.record_entries(study_warm_entries(study, devices))

    def record_entries(self, new_entries: list[dict]) -> int:
        """Merge entry rows into the manifest — the shared write path for
        per-study tuples (:meth:`record`) and the coalescer's blessed-width
        group tuples (:func:`repro_torch.serve.coalesce.group_warm_entries`)."""
        entries = self.load_manifest()
        seen = {_entry_key(e) for e in entries}
        fresh = [e for e in new_entries if _entry_key(e) not in seen]
        if fresh:
            tmp = self.manifest_path.with_suffix(".tmp")
            tmp.write_text(json.dumps(
                {"schema_version": MANIFEST_SCHEMA_VERSION,
                 "entries": entries + fresh}, indent=2) + "\n")
            tmp.replace(self.manifest_path)
        return len(fresh)

    def warm(self, entries: list[dict]) -> int:
        """Replay manifest entries once each through the engine's shared
        dispatch on all-sentinel lanes: any missing library is built,
        every library the entries' dispatches launch is bound, and every
        kernel they launch runs once in this process.  Returns the number
        of dispatches replayed; :attr:`warm_wall_s` holds the host seconds
        it took.

        Entries recorded on a wider lane mesh than this host has
        (``devices`` past the visible devices — a manifest carried over
        from a bigger machine) are *skipped*, counted in
        :attr:`skipped_entries`: live traffic rebuilds its own warm state
        at this host's routing — a replay must never wedge the restart.
        The others replay at their recorded mesh size."""
        t0 = time.perf_counter()
        avail = _mesh.available_devices(self.device)
        replayed = 0
        for e in entries:
            d = int(e.get("devices", 1))
            if d > avail:
                self.skipped_entries += 1
                continue
            stt, shw, scfg = dummy_stacked(e, self.device)
            # the thunk copies every accumulator to the host: it has run
            _engine._sweep_accs(stt, shw, (e["mechanism"],), scfg, devices=d)
            replayed += 1
        self.warm_wall_s = time.perf_counter() - t0
        return replayed

    def warm_from_manifest(self) -> int:
        return self.warm(self.load_manifest())
