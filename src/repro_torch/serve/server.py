"""The resident study server: a hardened request loop over the planner
(PyTorch port of :mod:`repro.serve.server`).

One long-lived :class:`StudyServer` answers many small ``Study`` requests
on one device (``ServeConfig.device``; ``None`` is the CUDA card, and
without one the server raises unless ``device="cpu"`` is given).  The
loop is cooperative and single-worker — ``submit`` admits, ``step``
serves one request or one coalesced group — which keeps every failure
decision deterministic and lets the chaos harness replay a whole storm
bit for bit.  The hardening layers, in request order:

* **Admission control** — malformed specs are rejected with the planner's
  own naming ``ValueError``; oversized requests are rejected by the lane
  bound (``Study.num_points`` — computed *without* synthesizing a trace);
  a full queue sheds load immediately (:mod:`repro_torch.serve.queueing`).
* **Deadline + hang detection** — every engine dispatch is a cancellation
  point (:meth:`repro_torch.sim.study.Study.run`'s ``on_dispatch``
  boundary): past-deadline requests abort with ``timeout``, and a worker
  whose heartbeat goes stale (:class:`~repro_torch.runtime.fault_tolerance
  .HeartbeatMonitor`) is flagged, cordoned (``remove_host`` — the restart
  path MUST forget the dead worker or the monitor poisons every later
  request) and replaced.
* **Retry with backoff** — transient engine failures are retried with
  capped exponential backoff + deterministic Threefry jitter
  (:mod:`repro_torch.serve.retry`).
* **Graceful degradation** — when the batched engine keeps failing, the
  request falls back to the sequential engine, which computes the *same
  numbers bit for bit*, so a degraded answer is never a wrong answer.
* **Fault-isolated coalescing** (``cfg.coalesce``) — compatible queued
  requests share ONE blessed-width batched dispatch
  (:mod:`repro_torch.serve.coalesce`) and split results by lane slice.  A
  dispatch that fails, hangs, or trips the per-lane integrity sentinel is
  *bisected*: healthy halves answer from their own successful
  sub-dispatches, the poison request is quarantined with its bisection
  trace (:attr:`StudyServer.quarantine`) instead of retried forever, and
  a sequential spot-check audit on a seeded Threefry lane sample degrades
  a finitely-corrupted batch to the bit-exact sequential engine.
* **Crash-safe warm restart** — admitted JSON requests are journaled;
  served studies' dispatch tuples are recorded in the warm manifest
  (:mod:`repro_torch.serve.warm`).  After a crash, :func:`restart_server`
  rebuilds the server, replays every recorded dispatch once on the
  server's device (building any missing library, binding each, loading
  each kernel it launches) and re-answers the journaled requests — with
  zero ``nvcc`` builds and zero new library binds for previously seen
  studies.

The lane mesh is one device (``devices`` above 1 raises, naming ROADMAP
A9).
"""

from __future__ import annotations

import dataclasses
import json
from collections import Counter
from typing import Any

from repro_torch.core.mechanisms import ResultIntegrityError
from repro_torch.device import resolve_device
from repro_torch.runtime.fault_tolerance import (
    HeartbeatMonitor,
    RestartPolicy,
    StragglerDetector,
)
from repro_torch.serve import request as _rq
from repro_torch.serve.chaos import ChaosMonkey, SimulatedCrash
from repro_torch.serve.clock import WallClock
from repro_torch.serve.coalesce import (
    BLESSED_LANE_WIDTHS,
    audit_sample,
    group_key,
    group_warm_entries,
    stack_group,
)
from repro_torch.serve.policy import AdaptivePolicy, PolicyConfig, Telemetry
from repro_torch.serve.queueing import BoundedQueue
from repro_torch.serve.request import Response, StudyRequest, build_study
from repro_torch.serve.retry import RetryPolicy
from repro_torch.serve.warm import WarmCache
from repro_torch.sim import engine as _engine
from repro_torch.sim import mesh as _mesh
from repro_torch.sim.study import Dispatch

WORKER = 0  # host id of the single in-process worker in the monitors
JOURNAL_NAME = "journal.json"


class DeadlineExceeded(Exception):
    """Raised at a cancellation point: deadline passed or worker hung."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_queue: int = 64             # bounded backlog; beyond it, shed
    max_lanes: int = 4096           # admission bound on folded lane count
    default_deadline_s: float = 300.0
    max_attempts: int = 3           # batched attempts before degrading
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    heartbeat_timeout_s: float = 30.0
    cache_dir: str | None = None    # warm manifest + journal
    warm_on_start: bool = True      # replay the warm manifest at boot
    seed: int = 0                   # retry-jitter + audit-sample stream
    # Cross-request lane coalescing (repro_torch.serve.coalesce).  Off by
    # default: the one-at-a-time loop is the behavior the legacy chaos
    # storms replay bit for bit, and the bit-exactness tests compare a
    # coalescing server against it.
    coalesce: bool = False
    max_batch_lanes: int = 64       # group lane budget (<= largest blessed)
    audit_fraction: float = 0.25    # lane fraction spot-checked sequentially
    study_cache: int = 32           # resident Studies reused for repeat
    #                                 specs (skips re-synthesis); 0 disables
    devices: int | None = None      # lane-mesh width for batched dispatches
    #                                 (None or 1: one device; more raises,
    #                                 the lane mesh is ROADMAP A9)
    # Adaptive coalescing policy (repro_torch.serve.policy).  Off by
    # default: greedy immediate formation at the full lane budget is the
    # behavior the chaos storms and bit-exactness tests pin.
    adaptive: bool = False
    formation_window_s: float = 0.02  # max hold awaiting compatible peers
    depth_threshold: int = 4          # backlog >= this: form immediately
    offender_threshold: float = 3.0   # offense score >= this: sequential
    offender_decay: float = 0.5       # score *= decay per clean dispatch
    # The port's own field: where every Study is built and every dispatch
    # runs.  None = the CUDA card (raises without one); "cpu" = the plain
    # PyTorch path.
    device: Any = None

    def __post_init__(self):
        if self.adaptive and not self.coalesce:
            raise ValueError(
                "ServeConfig(adaptive=True) requires coalesce=True: the "
                "policy decides formation, width, and offender routing "
                "for coalesced dispatches")


@dataclasses.dataclass
class _HeldGroup:
    """A coalesced group held open for formation (adaptive policy): the
    members are already out of the queue, waiting until ``hold_until``
    for compatible peers to arrive before dispatching."""

    key: object
    members: list
    hold_until: float
    budget: int


class StudyServer:
    def __init__(self, cfg: ServeConfig | None = None, *, clock=None,
                 chaos: ChaosMonkey | None = None):
        self.cfg = cfg or ServeConfig()
        self.device = resolve_device(self.cfg.device)
        self.clock = clock or WallClock()
        self.chaos = chaos
        self.queue = BoundedQueue(self.cfg.max_queue)
        self.retry = RetryPolicy(max_attempts=self.cfg.max_attempts,
                                 base_s=self.cfg.backoff_base_s,
                                 cap_s=self.cfg.backoff_cap_s,
                                 seed=self.cfg.seed)
        self.hb = HeartbeatMonitor(timeout_s=self.cfg.heartbeat_timeout_s)
        self.stragglers = StragglerDetector()
        # One logical worker host with 4 devices out of a 2-host pool: a
        # worker death/hang costs half the pool, which RestartPolicy maps
        # to a remesh (replace the worker), not a halt.
        self.restart_policy = RestartPolicy(total_devices=8, min_devices=4)
        self.warm = (WarmCache(self.cfg.cache_dir, device=self.device)
                     if self.cfg.cache_dir else None)
        self.crashed = False
        self.responses: dict[int, Response] = {}
        self.stats = Counter()
        self.restart_plans: list[dict] = []
        self.quarantine: dict[int, dict] = {}  # rid -> diagnostic record
        self._next_rid = 0
        self._journal: dict[int, dict] = {}
        # Per-request service-time estimate (s); None until the first
        # healthy observation.  None is the ONLY "unset" sentinel — 0.0 is
        # a legitimate observation (fake test clocks, sub-resolution fast
        # paths) that must decay through the EMA, not hard-reset it.
        self._service_ema: float | None = None
        self._devices = _mesh.resolve_devices(self.cfg.devices)
        self._group_tag = 0      # coalesced-dispatch counter (audit stream)
        self._study_cache: dict[str, object] = {}  # spec json -> Study (LRU)
        # Telemetry is always on (pure accumulation, no clock reads); the
        # adaptive policy only when configured, sharing the same sink.
        self.telemetry = Telemetry()
        self.policy: AdaptivePolicy | None = None
        if self.cfg.adaptive:
            self.policy = AdaptivePolicy(
                PolicyConfig(
                    formation_window_s=self.cfg.formation_window_s,
                    depth_threshold=self.cfg.depth_threshold,
                    offender_threshold=self.cfg.offender_threshold,
                    offender_decay=self.cfg.offender_decay),
                telemetry=self.telemetry)
        self._held: _HeldGroup | None = None
        self._hold_sleep_s = 0.0  # formation wait inside the current step
        if self.warm:
            self._journal_load()
            if self.cfg.warm_on_start:
                self.stats["warmed_entries"] = self.warm.warm_from_manifest()

    # -- journal (crash safety for admitted JSON requests) ------------------

    def _journal_path(self):
        return self.warm.dir / JOURNAL_NAME

    def _journal_load(self):
        path = self._journal_path()
        if not path.exists():
            return
        try:
            data = json.loads(path.read_text())
            inflight = {int(k): v for k, v in data["inflight"].items()}
            next_rid = int(data["next_rid"])
        except (json.JSONDecodeError, KeyError, TypeError, ValueError,
                AttributeError):
            # A torn journal write must cost the in-flight replays, never
            # wedge restart_server: quarantine the bad file for diagnosis
            # and start from an empty journal.
            n = 0
            while (q := path.with_name(
                    f"{JOURNAL_NAME}.corrupt-{n}")).exists():
                n += 1
            path.replace(q)
            self.stats["quarantined_journals"] += 1
            return
        self._journal = inflight
        self._next_rid = max(next_rid, max(self._journal, default=-1) + 1)

    def _journal_save(self):
        if self.warm is None:
            return
        tmp = self._journal_path().with_suffix(".tmp")
        tmp.write_text(json.dumps(
            {"next_rid": self._next_rid,
             "inflight": {str(k): v for k, v in self._journal.items()}},
            indent=2) + "\n")
        tmp.replace(self._journal_path())

    def _journal_add(self, req: StudyRequest):
        if self.warm is not None and req.spec is not None:
            self._journal[req.rid] = {"spec": req.spec,
                                      "deadline_s": req.deadline_s}
            self._journal_save()

    def _journal_clear(self, rid: int):
        if self._journal.pop(rid, None) is not None:
            self._journal_save()

    # -- admission ----------------------------------------------------------

    def submit(self, spec, deadline_s: float | None = None) -> int | Response:
        """Admit one request.  Returns the assigned rid when queued, or a
        terminal reject :class:`Response` (malformed / oversized /
        overload).  Every submission consumes one rid, rejected or not, so
        a storm's rid sequence is reproducible."""
        # An explicit non-positive deadline is a caller bug, not a "use
        # the default" marker (a falsy float is never an unset sentinel —
        # only None is).  Reject it by name
        # before a rid is even assigned: this is API misuse, not a
        # request outcome.
        if deadline_s is not None and not deadline_s > 0:
            raise ValueError(
                f"deadline_s must be positive, got {deadline_s!r} (pass "
                f"None for the default "
                f"{self.cfg.default_deadline_s:.0f}s)")
        rid = self._next_rid
        self._next_rid += 1
        raw = spec if isinstance(spec, dict) else None
        try:
            study = self._build_cached(spec, raw)
        except ValueError as e:
            return self._resolve(Response(rid, _rq.REJECTED_MALFORMED,
                                          error=str(e)))
        lanes = study.num_points
        if lanes > self.cfg.max_lanes:
            return self._resolve(Response(
                rid, _rq.REJECTED_OVERSIZED,
                error=f"request folds to {lanes} lanes > max_lanes="
                      f"{self.cfg.max_lanes}; split the study"))
        dl = (self.cfg.default_deadline_s if deadline_s is None
              else float(deadline_s))
        # Deadline accounting includes queue wait: a request predicted to
        # expire *before the worker reaches it* is shed now, as overload —
        # dispatching it late would burn worker time on a guaranteed
        # timeout and delay every request queued behind it.
        if self._service_ema is not None:
            est_wait = self._service_ema * (len(self.queue) + 1)
            if est_wait > dl:
                return self._resolve(Response(
                    rid, _rq.REJECTED_OVERLOAD,
                    error=f"would expire while queued: estimated "
                          f"completion in {est_wait:.1f}s (queue depth "
                          f"{len(self.queue)}) exceeds the {dl:.1f}s "
                          f"deadline; shed at admission"))
        req = StudyRequest(
            rid=rid, study=study, spec=raw,
            deadline_s=dl,
            submitted_at=self.clock.now())
        if not self.queue.offer(req):
            return self._resolve(Response(
                rid, _rq.REJECTED_OVERLOAD,
                error=f"queue full ({self.queue.maxlen}); load shed"))
        self._journal_add(req)
        return rid

    def _build_cached(self, spec, raw: dict | None):
        """Build the request's Study, reusing the resident instance for a
        repeat JSON spec.  A resident service sees the same study specs
        over and over (the same reason the warm manifest exists); `Study`
        caches its synthesized+prepared trace tensors per instance, so
        reusing the instance answers repeats without re-running trace
        synthesis.  `Study.run` is pure — sharing one instance across
        queued requests (even within one coalesced group) is safe."""
        if raw is None or self.cfg.study_cache <= 0:
            return build_study(spec, self.device)
        key = json.dumps(raw, sort_keys=True, default=str)
        cached = self._study_cache.pop(key, None)
        if cached is not None:
            self._study_cache[key] = cached  # re-insert: LRU order
            self.stats["study_cache_hits"] += 1
            return cached
        study = build_study(spec, self.device)
        self._study_cache[key] = study
        while len(self._study_cache) > self.cfg.study_cache:
            self._study_cache.pop(next(iter(self._study_cache)))
        return study

    # -- the request loop ---------------------------------------------------

    def step(self) -> Response | list[Response] | None:
        """Serve the oldest queued request (None when idle or crashed).
        With ``cfg.coalesce`` the step serves the head's whole compatible
        *group* in one shared dispatch and returns the list of responses it
        resolved; otherwise the single-request loop, one Response.  A
        step that *holds* a group for formation (adaptive policy) returns
        an empty list — progress, not idleness, so ``drain`` keeps going."""
        if self.crashed:
            return None
        self.telemetry.observe_depth(len(self.queue))
        self._hold_sleep_s = 0.0
        if self._held is not None:
            t0 = self.clock.now()
            out = self._continue_hold()
        else:
            req = self.queue.pop()
            if req is None:
                return None
            t0 = self.clock.now()
            out = (self._step_coalesced(req) if self.cfg.coalesce
                   else self._process(req))
        resolved = out if isinstance(out, list) else [out]
        # Crash/quarantine steps don't inform the estimate: their wall is
        # fault handling (hang timeouts accumulated across bisection
        # sub-dispatches, worker replacement), not service — folding it in
        # inflates the EMA until healthy admissions shed as overload.
        # Members that timed out at group formation never consumed worker
        # time either, so they don't count toward the per-request divisor;
        # a step that resolved ONLY timeouts observes nothing.  Formation
        # waits (``_hold_sleep_s``) are deliberate idling, not service —
        # they are subtracted before the EMA sees the wall.
        if not any(r.status in (_rq.CRASHED, _rq.QUARANTINED)
                   for r in resolved):
            served = [r for r in resolved if r.status != _rq.TIMEOUT]
            if served:
                self._observe_service(
                    max(self.clock.now() - t0 - self._hold_sleep_s, 0.0)
                    / len(served))
        return out

    def _observe_service(self, s: float):
        """EMA of per-request service time — the admission-shed estimate.
        ``None`` (never observed) seeds from the first sample; any float —
        including a legitimate 0.0 from a fake clock — decays normally."""
        s = max(s, 0.0)
        self._service_ema = (s if self._service_ema is None
                             else 0.8 * self._service_ema + 0.2 * s)

    def drain(self) -> list[Response]:
        """Serve until the queue is empty (or the worker crashes)."""
        out = []
        while (r := self.step()) is not None:
            out.extend(r if isinstance(r, list) else [r])
        return out

    # -- processing: retry -> degrade, under deadline + heartbeat -----------

    def _resolve(self, resp: Response) -> Response:
        self.responses[resp.rid] = resp
        self.stats[resp.status] += 1
        self.telemetry.observe_response(resp)
        self._journal_clear(resp.rid)
        return resp

    def _hang_check(self):
        """Worker-liveness half of the cancellation point (also the whole
        check for coalesced dispatches, which have no single deadline)."""
        if WORKER in self.hb.dead_hosts(now=self.clock.now()):
            self.stats["hangs_detected"] += 1
            self._replace_worker("heartbeat stale (hang)")
            raise DeadlineExceeded(
                f"worker heartbeat stale past "
                f"{self.cfg.heartbeat_timeout_s:.0f}s (hang detected)")

    def _cancel_check(self, req: StudyRequest):
        """The cancellation point: every dispatch passes through here."""
        self._hang_check()
        if self.clock.now() > req.deadline():
            raise DeadlineExceeded(
                f"deadline {req.deadline_s:.1f}s exceeded")

    def _replace_worker(self, why: str):
        """The restart path for a dead/hung worker: plan the reaction and
        *forget the host* — without ``remove_host`` the monitor would keep
        reporting the old incarnation dead and poison every later check."""
        plan = self.restart_policy.plan([WORKER], devices_per_host=4)
        self.restart_plans.append({"why": why, **plan})
        self.hb.remove_host(WORKER)

    def _boundary(self, req: StudyRequest, attempt: int):
        def boundary(info, thunk):
            self._cancel_check(req)
            if self.chaos is not None:
                self.chaos.on_dispatch(req.rid, attempt, info)
            self._cancel_check(req)
            now = self.clock.now()
            self.hb.beat(WORKER, attempt, now=now)
            acc = thunk()
            done = self.clock.now()
            # Trailing beat: completing a dispatch proves liveness, so a
            # legitimately slow thunk (a first launch that builds and
            # binds a library) is a straggler observation, never a false
            # hang.
            self.hb.beat(WORKER, attempt, now=done)
            self.stragglers.observe(WORKER, max(done - now, 1e-9))
            return acc
        return boundary

    def _process(self, req: StudyRequest) -> Response:
        def finish(status, results=None, engine=None, attempts=0, error=None):
            return self._resolve(Response(
                req.rid, status, results=results, engine=engine,
                attempts=attempts, error=error,
                latency_s=self.clock.now() - req.submitted_at))

        last_err: Exception | None = None
        attempt = 0
        while attempt < self.retry.max_attempts:
            try:
                self.hb.beat(WORKER, attempt, now=self.clock.now())
                # Materialize traces outside the dispatch boundary and
                # re-arm the heartbeat: synthesis is legitimate work, not a
                # hang, and on attempt 0 it can take longer than the
                # heartbeat timeout (its first launches build and bind).
                req.study.traces()
                self.hb.beat(WORKER, attempt, now=self.clock.now())
                rs = req.study.run(engine="batch",
                                   on_dispatch=self._boundary(req, attempt),
                                   devices=self._devices)
                if self.warm is not None:
                    self.warm.record(req.study, devices=self._devices)
                if attempt:
                    self.stats["retry_successes"] += 1
                return finish(_rq.OK, rs, engine="batch",
                              attempts=attempt + 1)
            except DeadlineExceeded as e:
                return finish(_rq.TIMEOUT, attempts=attempt + 1,
                              error=str(e))
            except SimulatedCrash as e:
                return self._crash(req, attempt, e)
            except Exception as e:  # engine failure: injected or real
                last_err = e
                attempt += 1
                self.stats["engine_failures"] += 1
                if attempt < self.retry.max_attempts:
                    self.clock.sleep(self.retry.backoff_s(req.rid, attempt))

        # Batched attempts exhausted: degrade to the sequential engine
        # (bit-exact with the planner on every SimResult field).
        self.stats["degraded_dispatches"] += 1
        try:
            rs = req.study.run(engine="sequential",
                               on_dispatch=self._boundary(req, attempt))
            return finish(
                _rq.OK_DEGRADED, rs, engine="sequential", attempts=attempt,
                error=f"degraded to sequential after {attempt} batched "
                      f"failures: {last_err}")
        except DeadlineExceeded as e:
            return finish(_rq.TIMEOUT, attempts=attempt, error=str(e))
        except SimulatedCrash as e:
            return self._crash(req, attempt, e)
        except Exception as e:
            return finish(
                _rq.FAILED, attempts=attempt,
                error=f"batched: {last_err}; sequential: {e}")

    def _crash(self, req: StudyRequest, attempt: int, e: Exception) -> Response:
        """Worker death mid-request: journal entry is kept (NOT cleared) so
        a restarted server re-answers it; the response is the explicit
        crash marker, never a silent drop."""
        self.crashed = True
        self._replace_worker("worker crash")
        resp = Response(req.rid, _rq.CRASHED, attempts=attempt + 1,
                        error=str(e),
                        latency_s=self.clock.now() - req.submitted_at)
        self.responses[req.rid] = resp
        self.stats[_rq.CRASHED] += 1
        self.telemetry.observe_response(resp)
        return resp

    # -- cross-request lane coalescing (repro_torch.serve.coalesce) ---------

    def _step_coalesced(self, head: StudyRequest) -> list[Response]:
        """Serve the head request's whole compatible group in one shared
        blessed-width dispatch; incompatible (multi-bucket / over-budget)
        heads fall back to the single-request loop.  With the adaptive
        policy on, a chronic-offender group key routes straight to the
        sequential reference, and a shallow-but-live backlog may *hold*
        the freshly formed group for a formation window instead of
        dispatching immediately (the hold returns [] and the next step
        finishes the group)."""
        budget = min(self.cfg.max_batch_lanes, BLESSED_LANE_WIDTHS[-1])
        try:
            key = group_key(head.study)
        except Exception:
            key = None  # synthesis failure: let _process surface it
        if key is None or head.study.num_points > budget:
            return [self._process(head)]
        if self.policy is not None and self.policy.route_sequential(key):
            return [self._route_offender(head, key)]

        depth = len(self.queue)  # backlog behind the head: the load signal
        members, total = self._take_compat(key, [head], budget)
        self.stats["coalesced_groups"] += 1

        if self.policy is not None:
            now = self.clock.now()
            window = self.policy.formation_window(
                depth=depth, lanes=total, lane_budget=budget,
                min_slack_s=min(r.deadline() - now for r in members))
            if window > 0.0:
                self.stats["formation_holds"] += 1
                self.telemetry.formation_holds += 1
                self._held = _HeldGroup(key=key, members=members,
                                        hold_until=now + window,
                                        budget=budget)
                return []
        return self._finish_group(key, members)

    def _take_compat(self, key, members: list[StudyRequest],
                     budget: int) -> tuple[list[StudyRequest], int]:
        """Pull every queued request compatible with ``key`` into the
        group, oldest first, until the lane budget fills.  With the
        adaptive policy on, the budget is additionally capped by the
        slack-driven blessed width: the tightest member's deadline slack
        bounds how wide a dispatch the whole group may ride (never below
        the lanes already committed — the members must dispatch at *some*
        width regardless)."""
        total = sum(r.study.num_points for r in members)
        now = self.clock.now()
        slack = min(r.deadline() - now for r in members)

        def compat(r: StudyRequest) -> bool:
            nonlocal total, slack
            cap = budget
            r_slack = min(slack, r.deadline() - now)
            if self.policy is not None:
                cap = min(budget,
                          max(self.policy.width_budget(r_slack), total))
            if total + r.study.num_points > cap:
                if (self.policy is not None
                        and total + r.study.num_points <= budget):
                    self.telemetry.decisions["width_capped"] += 1
                return False
            try:
                if group_key(r.study) != key:
                    return False
            except Exception:
                return False
            total += r.study.num_points
            slack = r_slack
            return True

        members = members + self.queue.take(compat)
        return members, total

    def _continue_hold(self) -> list[Response]:
        """One step of an open formation hold: sweep the queue for peers
        that arrived since the hold began, then either keep holding (new
        members joined and the window + every member's slack still
        afford it), wait out the remaining window (no arrivals — in the
        cooperative loop nothing can join mid-sleep), or dispatch."""
        held, self._held = self._held, None
        before = len(held.members)
        members, total = self._take_compat(held.key, held.members,
                                           held.budget)
        now = self.clock.now()
        remaining = held.hold_until - now
        if remaining > 0.0 and total < held.budget:
            # A tight-slack joiner shortens the window: the hold never
            # outlives any member's slack (minus the predicted dispatch).
            spare = self.policy.hold_spare(
                min(r.deadline() - now for r in members))
            remaining = min(remaining, spare)
            if remaining > 0.0:
                if len(members) > before:
                    self._held = dataclasses.replace(
                        held, members=members,
                        hold_until=now + remaining)
                    return []
                self.clock.sleep(remaining)
                self._hold_sleep_s += remaining
        return self._finish_group(held.key, members)

    def _route_offender(self, req: StudyRequest, key) -> Response:
        """Serve a chronic-offender group key's request directly on the
        bit-exact sequential reference: its decayed offense score says a
        batched dispatch ends in bisection or audit degradation anyway,
        so skip the dance.  Clean serves decay the score
        (``policy.record_clean``), healing the key back to batched
        routing — this is a detour, not an exile."""
        self.stats["offender_routed"] += 1
        try:
            rs = req.study.run(engine="sequential",
                               on_dispatch=self._boundary(req, 0))
        except DeadlineExceeded as e:
            return self._resolve(Response(
                req.rid, _rq.TIMEOUT, attempts=1, error=str(e),
                latency_s=self.clock.now() - req.submitted_at))
        except SimulatedCrash as e:
            return self._crash(req, 0, e)
        except Exception as e:
            return self._resolve(Response(
                req.rid, _rq.FAILED, attempts=1,
                error=f"sequential (offender-routed): {e}",
                latency_s=self.clock.now() - req.submitted_at))
        self.policy.record_clean(key)
        return self._resolve(Response(
            req.rid, _rq.OK_DEGRADED, results=rs, engine="sequential",
            attempts=1,
            error="repeat-offender group key routed to the sequential "
                  "reference (bit-exact)",
            latency_s=self.clock.now() - req.submitted_at))

    def _finish_group(self, key, members: list[StudyRequest]
                      ) -> list[Response]:
        """Dispatch a formed (possibly held) group.  Members already past
        their deadline time out at group formation — stacking them would
        waste lanes on a guaranteed-late answer — and their journal
        entries clear through ``_resolve`` like any terminal response, so
        a restart never re-answers a request that already timed out
        between ``take`` and dispatch."""
        now = self.clock.now()
        out, live = [], []
        for r in members:
            if now > r.deadline():
                out.append(self._resolve(Response(
                    r.rid, _rq.TIMEOUT,
                    error=f"deadline {r.deadline_s:.1f}s exceeded while "
                          f"queued",
                    latency_s=now - r.submitted_at)))
            else:
                live.append(r)
        if live:
            results: dict[int, Response] = {}
            self._bisect_serve(key, live, [], results)
            out.extend(results[r.rid] for r in live)
        return out

    def _dispatch_coalesced(self, key, members: list[StudyRequest]):
        """ONE batched engine execution for the whole group: member lanes
        stacked in member order, padded to the blessed width with masked
        sentinel lanes.  Returns ``(accs, slices, width)`` with host-side
        accumulators carrying the stacked lane axis."""
        self.hb.beat(WORKER, 0, now=self.clock.now())
        # Route the group like the planner routes a bucket: the largest
        # pow2 device subset its real lanes fill (one device in the port).
        # Every blessed width >= the (pow2) mesh size is already a mesh
        # multiple.
        d = _mesh.devices_for(sum(r.study.num_points for r in members),
                              self._devices)
        stt, shw, scfg, slices, width = stack_group(
            key, [(r.rid, r.study) for r in members], devices=d,
            device=self.device)
        rids = [s.rid for s in slices]

        def boundary(m, thunk):
            self._hang_check()
            if self.chaos is not None:
                self.chaos.on_coalesced_dispatch(
                    rids, Dispatch(engine="coalesced", mechanism=m,
                                   lanes=width, devices=d))
            self._hang_check()
            now = self.clock.now()
            self.hb.beat(WORKER, 0, now=now)
            acc = thunk()
            done = self.clock.now()
            self.hb.beat(WORKER, 0, now=done)
            self.stragglers.observe(WORKER, max(done - now, 1e-9))
            return acc

        self.stats["coalesced_dispatches"] += 1
        t_dispatch = self.clock.now()
        accs = _engine._sweep_accs(stt, shw, key.mechanisms, scfg,
                                   boundary=boundary, devices=d)
        self.telemetry.observe_width(width)
        if self.policy is not None:
            # The width-indexed dispatch-wall EMA behind every slack
            # decision (formation affordability, slack-driven width).
            self.policy.model.observe(
                width, self.clock.now() - t_dispatch)
        if self.chaos is not None:
            accs = self.chaos.corrupt_accs(
                [(s.rid, s.slice) for s in slices], accs)
        return accs, slices, width

    def _bisect_serve(self, key, members: list[StudyRequest],
                      trace: list[dict], results: dict[int, Response]):
        """Serve a member set through one coalesced dispatch, bisecting on
        failure: a failed/hung multi-member dispatch splits in half and
        recurses (each recursion halves, so termination is structural); a
        failed singleton IS the poison and is quarantined with the
        accumulated bisection ``trace`` instead of retried forever.
        Healthy halves are answered from their own successful
        sub-dispatches — the blast radius of a poison request is bounded
        at one."""
        rids = [r.rid for r in members]
        try:
            accs, slices, width = self._dispatch_coalesced(key, members)
        except SimulatedCrash as e:
            self.crashed = True
            self._replace_worker("worker crash")
            trace.append({"members": rids, "outcome": f"crash: {e}"})
            now = self.clock.now()
            for r in members:
                resp = Response(r.rid, _rq.CRASHED, attempts=1,
                                error=str(e),
                                latency_s=now - r.submitted_at)
                self.responses[r.rid] = resp
                self.stats[_rq.CRASHED] += 1
                results[r.rid] = resp  # journal kept: replay re-answers
            return
        except Exception as e:
            trace.append({"members": rids, "outcome": f"failed: {e}"})
            if len(members) == 1:
                if self.policy is not None:
                    self.policy.record_offense(key)
                results[rids[0]] = self._quarantine(
                    members[0],
                    f"poison request isolated by bisection: every "
                    f"coalesced dispatch containing it failed (last: {e})",
                    trace)
                return
            self.stats["bisections"] += 1
            mid = len(members) // 2
            self._bisect_serve(key, members[:mid], trace, results)
            if not self.crashed:
                self._bisect_serve(key, members[mid:], trace, results)
            return

        trace.append({"members": rids, "width": width, "outcome": "ok"})
        if self.warm is not None:
            d = _mesh.devices_for(
                sum(r.study.num_points for r in members), self._devices)
            self.warm.record_entries(group_warm_entries(key, width,
                                                        devices=d))
        self._settle_group(key, members, accs, slices, trace, results)

    def _settle_group(self, key, members, accs, slices, trace, results):
        """Split a successful dispatch back per request: every lane passes
        the finalize integrity sentinel (NaN/Inf/negative → lane-exact
        quarantine), then a deterministic Threefry sample of the surviving
        lanes is audited against the sequential reference; any mismatch
        degrades the whole sub-batch to sequential (bit-exact), because a corrupt-but-finite accumulator has no
        trustworthy lane attribution."""
        now = self.clock.now()
        healthy = []  # (request, finalized ResultSet)
        for r, s in zip(members, slices):
            member_accs = {m: {k: v[s.slice] for k, v in acc.items()}
                           for m, acc in accs.items()}
            try:
                rs = r.study.points_from_lane_accs(member_accs)
            except ResultIntegrityError as e:
                if self.policy is not None:
                    self.policy.record_offense(key)
                results[r.rid] = self._quarantine(
                    r, f"per-lane integrity sentinel tripped in coalesced "
                       f"dispatch (lane-exact attribution): {e}", trace)
                continue
            healthy.append((r, rs))

        owners = [(r, rs, local) for r, rs in healthy
                  for local in range(len(rs.points))]
        sample = audit_sample(self.cfg.seed, self._group_tag, len(owners),
                              self.cfg.audit_fraction)
        self._group_tag += 1
        mismatch = None
        for lane in sample:
            self.stats["audit_lanes"] += 1
            r, rs, local = owners[lane]
            if not self._audit_lane(r, rs, local, key.mechanisms):
                mismatch = (r.rid, lane)
                break

        if mismatch is None:
            if self.policy is not None and healthy:
                self.policy.record_clean(key)
            for r, rs in healthy:
                results[r.rid] = self._resolve(Response(
                    r.rid, _rq.OK, results=rs, engine="coalesced",
                    attempts=1,
                    latency_s=self.clock.now() - r.submitted_at))
            return

        # Audit mismatch: the answer is wrong but finite, so no lane can
        # be trusted — recompute every member on the sequential reference.
        self.stats["audit_mismatches"] += 1
        if self.policy is not None:
            self.policy.record_offense(key)
        trace.append({"members": [r.rid for r, _ in healthy],
                      "outcome": f"audit mismatch (rid={mismatch[0]}, "
                                 f"lane={mismatch[1]}): degrading batch "
                                 f"to sequential"})
        for r, _ in healthy:
            try:
                rs = r.study.run(engine="sequential",
                                 on_dispatch=self._boundary(r, 0))
                results[r.rid] = self._resolve(Response(
                    r.rid, _rq.OK_DEGRADED, results=rs,
                    engine="sequential", attempts=1,
                    error="audit mismatch in coalesced batch; recomputed "
                          "on the sequential reference",
                    latency_s=self.clock.now() - r.submitted_at))
            except DeadlineExceeded as e:
                results[r.rid] = self._resolve(Response(
                    r.rid, _rq.TIMEOUT, attempts=1, error=str(e),
                    latency_s=self.clock.now() - r.submitted_at))

    def _audit_lane(self, req: StudyRequest, rs, local: int,
                    mechanisms) -> bool:
        """Spot-check one served lane field-exactly against the sequential
        engine (bit-exact with the batched planner — any difference means
        corruption)."""
        st = req.study
        (bl,) = st.bucket_lanes()
        w, h, li = st._lanes()[bl.lane_points[local]]
        point = rs.points[local]
        for m in mechanisms:
            ref = _engine.run_mechanism(st.traces()[w], st.hw_points()[h],
                                        m, st.lazy_points()[li],
                                        device=st.device)
            if dataclasses.asdict(ref) != dataclasses.asdict(
                    point.results[m]):
                return False
        return True

    def _quarantine(self, req: StudyRequest, reason: str,
                    trace: list[dict]) -> Response:
        """Terminal isolation of a poison request: the diagnostic record
        (reason + full bisection trace + the raw spec) lands in
        ``self.quarantine`` for offline analysis, the journal entry is
        cleared so no restart replays it, and the caller gets an explicit
        ``quarantined`` response — never an infinite retry loop."""
        self.quarantine[req.rid] = {
            "rid": req.rid,
            "reason": reason,
            "spec": req.spec,
            "bisection": [dict(ev) for ev in trace],
        }
        return self._resolve(Response(
            req.rid, _rq.QUARANTINED, error=reason,
            latency_s=self.clock.now() - req.submitted_at))

    # -- crash recovery -----------------------------------------------------

    def recover(self) -> list[Response]:
        """Re-answer every journaled in-flight request (fresh deadlines).
        Replayed rids are exempted from chaos injection — a deterministic
        fault oracle would otherwise kill the same request forever."""
        out = []
        for rid in sorted(self._journal):
            entry = self._journal[rid]
            if self.chaos is not None:
                self.chaos.exempt.add(rid)
            req = StudyRequest(rid=rid,
                               study=build_study(entry["spec"], self.device),
                               spec=entry["spec"],
                               deadline_s=entry["deadline_s"],
                               submitted_at=self.clock.now())
            resp = self._process(req)
            resp.restarted = True
            out.append(resp)
        return out


def restart_server(cfg: ServeConfig, *, clock=None,
                   chaos: ChaosMonkey | None = None
                   ) -> tuple[StudyServer, list[Response]]:
    """Bring up a replacement server after a crash: replay every manifest
    entry on its device (the port's warm state), then re-answer the
    journaled in-flight requests.  Returns (server, replayed
    responses)."""
    server = StudyServer(cfg, clock=clock, chaos=chaos)
    return server, server.recover()
