"""Deterministic fault-injection harness for the resident study service
(PyTorch port of :mod:`repro.serve.chaos`: the same draws, salts and
storms, bit for bit).

LazyPIM itself is speculation + conflict detection + rollback; this module
is the same discipline applied to the serving substrate: every failure
mode the request loop claims to survive is *injected on purpose*, from a
seeded counter-based RNG (the trace synthesizer's Threefry-2x32 core), so
one seed replays one exact storm — which request is faulted, with which
fault class, on which dispatch — bit-for-bit on any machine.

Fault classes (``FAULT_CLASSES``) and their required resolutions:

* ``malformed_spec``     → rejected at admission with a naming ValueError
                           (never reaches the engine);
* ``oversized``          → rejected at admission by the lane bound (never
                           synthesizes a trace or runs a window loop);
* ``engine_exception``   → transient: retry with backoff succeeds;
                           persistent: every *batched* dispatch fails and
                           the server degrades to the sequential reference
                           engine (bit-exact with the batched one);
* ``hang``               → a dispatch stalls past the request deadline;
                           the heartbeat monitor flags the worker dead and
                           the cancellation point aborts with ``timeout``;
* ``crash``              → the worker process dies mid-request; the
                           journaled request is re-answered by a restarted
                           server warmed from its manifest.

Coalescing-era classes (``COALESCE_FAULT_CLASSES``, opt-in — not in the
default draw so legacy storm replays stay bit-identical):

* ``poison_lane``        → every coalesced dispatch containing the request
                           raises; the server bisects the batch, answers
                           the healthy halves, and quarantines the
                           offender with its bisection trace;
* ``poison_result``      → the request's lane slice of the raw
                           accumulators is corrupted post-dispatch.  The
                           NaN variant trips the per-lane integrity
                           sentinel in ``finalize_result`` (lane-exact
                           attribution → quarantine); the finite variant
                           survives the sentinel and is caught by the
                           seeded sequential spot-check audit, which
                           degrades the whole batch to the sequential
                           reference (every member ``ok_degraded``,
                           bit-exact).

The harness never fabricates results: an injected fault can only ever
surface as a typed exception (or a corrupted *spec*, for the two admission
classes), so a wrong-but-plausible answer is impossible by construction —
the chaos suite additionally compares every served answer against the
fault-free sequential reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sim._traceref import threefry2x32

FAULT_CLASSES = ("malformed_spec", "oversized", "engine_exception",
                 "hang", "crash")
# Coalescing-path classes are opt-in: appending them to FAULT_CLASSES
# would shift the Threefry class draw and silently rewrite every
# committed legacy storm, so the default draw set stays frozen.
COALESCE_FAULT_CLASSES = ("poison_lane", "poison_result")
ALL_FAULT_CLASSES = FAULT_CLASSES + COALESCE_FAULT_CLASSES

# Draw-salt lanes: one per decision the monkey makes about a request.
_SALT_FAULTED = np.uint32(1)
_SALT_CLASS = np.uint32(2)
_SALT_TRANSIENT = np.uint32(3)
_SALT_VARIANT = np.uint32(4)
_SALT_BURST = np.uint32(5)


class InjectedEngineError(RuntimeError):
    """A chaos-injected engine dispatch failure (transient or persistent)."""


class SimulatedCrash(RuntimeError):
    """A chaos-injected worker death mid-dispatch."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    seed: int = 0
    fault_rate: float = 0.1
    classes: tuple[str, ...] = FAULT_CLASSES
    # Fraction of engine_exception faults that are transient (clear after
    # the first retry); the rest fail every batched attempt -> degrade.
    transient_fraction: float = 0.5
    # Virtual/real seconds a hang stalls a dispatch; must exceed both the
    # request deadline and the heartbeat timeout to exercise detection.
    hang_s: float = 60.0

    def __post_init__(self):
        unknown = set(self.classes) - set(ALL_FAULT_CLASSES)
        if unknown:
            raise ValueError(f"unknown fault classes {sorted(unknown)} "
                             f"(know {ALL_FAULT_CLASSES})")


class ChaosMonkey:
    """Seeded fault oracle + injector.

    ``fault_for(rid)`` is the pure decision function: which fault class (if
    any) request ``rid`` carries under this seed.  The two admission
    classes are applied by :func:`corrupt_spec` when the storm is
    generated; the three runtime classes fire inside the server's dispatch
    boundary via :meth:`on_dispatch`.  ``exempt`` rids are never faulted —
    the restart path exempts journaled requests it replays, because a
    deterministic oracle would otherwise crash the same request forever.
    """

    def __init__(self, cfg: ChaosConfig, clock=None):
        self.cfg = cfg
        self.clock = clock
        self.exempt: set[int] = set()
        self.injected: list[tuple[int, str]] = []  # (rid, class) log

    def _u01(self, rid: int, salt: np.uint32) -> float:
        x0, _ = threefry2x32(np.uint32(self.cfg.seed & 0xFFFFFFFF),
                             np.uint32(0xC4A05) ^ salt,
                             np.uint32(rid & 0xFFFFFFFF), salt)
        return float(int(x0) >> 8) * 2.0 ** -24

    def fault_for(self, rid: int) -> str | None:
        """The fault class injected into request ``rid``, or None."""
        if rid in self.exempt or not self.cfg.classes:
            return None
        if self._u01(rid, _SALT_FAULTED) >= self.cfg.fault_rate:
            return None
        i = int(self._u01(rid, _SALT_CLASS) * len(self.cfg.classes))
        return self.cfg.classes[min(i, len(self.cfg.classes) - 1)]

    def is_transient(self, rid: int) -> bool:
        return self._u01(rid, _SALT_TRANSIENT) < self.cfg.transient_fraction

    def variant(self, rid: int, n: int) -> int:
        """Deterministic sub-variant index in [0, n) (spec corruption)."""
        return min(int(self._u01(rid, _SALT_VARIANT) * n), n - 1)

    def burst(self, tick: int, max_n: int) -> int:
        """Deterministic arrival-burst size in [0, max_n] for interleaved
        storm drivers: how many submissions land before cooperative step
        ``tick`` runs.  Storms the adaptive policy's *formation window* —
        bursts arriving mid-hold join the held group, empty bursts force
        the hold to wait out its window — from the same seeded stream as
        every other chaos decision, so one seed replays one exact
        arrival interleaving.  A fresh salt lane: the legacy per-request
        draws (fault class, variant, ...) are untouched, so committed
        storms stay bit-identical."""
        if max_n < 0:
            raise ValueError(f"burst needs max_n >= 0, got {max_n}")
        return min(int(self._u01(tick, _SALT_BURST) * (max_n + 1)), max_n)

    # -- admission-class injection (storm generation) -----------------------

    def corrupt_spec(self, rid: int, spec: dict) -> dict:
        """Apply the request's admission-class fault (if any) to a good
        JSON spec; runtime classes leave the spec untouched."""
        kind = self.fault_for(rid)
        if kind == "malformed_spec":
            bad = dict(spec)
            v = self.variant(rid, 4)
            if v == 0:
                bad["workloads"] = list(spec["workloads"]) + ["chaos-bogus"]
            elif v == 1:
                bad["mechanisms"] = list(
                    spec.get("mechanisms", ("cpu",))) + ["warp"]
            elif v == 2:
                bad["workloads"] = list(spec["workloads"]) + [{"graph": "x"}]
            else:
                bad["threads"] = "sixteen"
            return bad
        if kind == "oversized":
            # A dense hw grid explodes the folded lane count past any sane
            # admission bound (strictly above the default 4096 max_lanes
            # even for a single-workload spec); the plan arithmetic catches
            # it pre-synthesis.
            bad = dict(spec)
            bad["hw_grid"] = {"offchip_bw_gbs": [float(b) for b in
                                                 range(16, 16 + 8192)]}
            return bad
        return spec

    # -- runtime-class injection (server dispatch boundary) -----------------

    def on_dispatch(self, rid: int, attempt: int, info) -> None:
        """Called inside the server's dispatch boundary, before the engine
        thunk runs.  Raises / stalls according to the request's fault class.
        Only batched dispatches are faulted: the sequential reference is
        the degradation target and must stay reachable (a real deployment
        degrades onto a *different* code path for exactly this reason)."""
        kind = self.fault_for(rid)
        if kind is None or info.engine != "batch":
            return
        if kind == "engine_exception":
            if self.is_transient(rid):
                if attempt == 0:
                    self.injected.append((rid, "engine_exception:transient"))
                    raise InjectedEngineError(
                        f"chaos: transient engine failure (rid={rid})")
            else:
                self.injected.append((rid, "engine_exception:persistent"))
                raise InjectedEngineError(
                    f"chaos: persistent batch-engine failure (rid={rid})")
        elif kind == "hang":
            if attempt == 0 and self.clock is not None:
                self.injected.append((rid, "hang"))
                self.clock.sleep(self.cfg.hang_s)
        elif kind == "crash":
            if attempt == 0:
                self.injected.append((rid, "crash"))
                raise SimulatedCrash(f"chaos: worker died (rid={rid})")

    # -- coalescing-class injection (shared-batch dispatch boundary) --------

    def on_coalesced_dispatch(self, rids: list[int], info) -> None:
        """Called inside the coalesced dispatch boundary before the engine
        thunk runs, with every member rid of the shared batch.  A
        ``poison_lane`` member fails the *whole* dispatch — that is the
        point: the fault is only isolatable by bisection, never by
        per-request attribution."""
        for rid in rids:
            if self.fault_for(rid) == "poison_lane":
                self.injected.append((rid, "poison_lane"))
                raise InjectedEngineError(
                    f"chaos: poison lane (rid={rid}) sank a coalesced "
                    f"dispatch of {len(rids)} request(s)")

    def corrupt_accs(self, lane_slices: list[tuple[int, slice]],
                     accs: dict) -> dict:
        """Apply ``poison_result`` corruption to the raw per-lane
        accumulators of a *successful* coalesced dispatch.  ``lane_slices``
        maps each member rid to its lane range in the stacked axis;
        ``accs`` is ``{mechanism: {field: array[lanes, ...]}}``.  Variant 0
        writes NaN (integrity sentinel catches it at finalize); variant 1
        scales ``time_ns`` by a finite factor (only the sequential audit
        can catch it)."""
        poisoned = [(rid, sl) for rid, sl in lane_slices
                    if self.fault_for(rid) == "poison_result"]
        if not poisoned:
            return accs
        accs = {m: {k: np.array(v) for k, v in fields.items()}
                for m, fields in accs.items()}
        for rid, sl in poisoned:
            v = self.variant(rid, 2)
            self.injected.append(
                (rid, f"poison_result:{'nan' if v == 0 else 'finite'}"))
            for fields in accs.values():
                if v == 0:
                    fields["time_ns"][sl] = np.nan
                else:
                    fields["time_ns"][sl] = fields["time_ns"][sl] * 1.5
        return accs


def make_storm(monkey: ChaosMonkey, n_requests: int,
               base_specs: list[dict], first_rid: int = 0) -> list[dict]:
    """A deterministic request storm: ``n_requests`` JSON specs drawn
    round-robin from ``base_specs``, each corrupted per its rid's fault
    class.  rids are assigned sequentially from ``first_rid`` — exactly how
    the server numbers admissions, so the oracle and the server agree on
    which request is which."""
    return [monkey.corrupt_spec(first_rid + i,
                                base_specs[i % len(base_specs)])
            for i in range(n_requests)]
