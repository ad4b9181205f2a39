"""The port's adaptive coalescing policy (``repro_torch.serve.policy``) on
the CPU, mirroring ``tests/test_policy.py``: formation window (held groups
never outlive any member's slack; mid-window arrivals share one dispatch),
slack-driven blessed width (monotone in slack; tight members cap the
group), repeat-offender routing (a decayed score sends a chronically
failing GroupKey to the sequential engine and heals it back), the
``deadline_s=0.0`` rejection, the audit-sample 1-lane floor, the
formation-timeout journal guarantee, and a chaos leg proving the
fault-class resolutions policy-transparent.  Set ``REPRO_CHAOS_SEED`` to
pin a single seed.

Held to ``repro`` itself: the policy's decisions, widths, holds and
telemetry on the same observation sequences, and each rid of the
formation storm for seeds 0, 1 and 2 (status, engine, ``to_rows()``).
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from repro.serve import AdaptivePolicy as RAdaptivePolicy
from repro.serve import ChaosConfig as RChaosConfig
from repro.serve import ChaosMonkey as RChaosMonkey
from repro.serve import PolicyConfig as RPolicyConfig
from repro.serve import ServeConfig as RServeConfig
from repro.serve import StudyServer as RStudyServer
from repro.serve import Telemetry as RTelemetry
from repro.serve import VirtualClock as RVirtualClock
from repro.serve import make_storm as r_make_storm
from repro_torch.serve import (
    BLESSED_LANE_WIDTHS,
    OK,
    OK_DEGRADED,
    QUARANTINED,
    REJECTED_MALFORMED,
    REJECTED_OVERSIZED,
    SERVED,
    TIMEOUT,
    AdaptivePolicy,
    ChaosConfig,
    ChaosMonkey,
    PolicyConfig,
    ServeConfig,
    ServiceModel,
    StudyServer,
    Telemetry,
    VirtualClock,
    audit_sample,
    build_study,
    group_key,
    make_storm,
    restart_server,
)

SEEDS = ([int(os.environ["REPRO_CHAOS_SEED"])]
         if "REPRO_CHAOS_SEED" in os.environ else [0, 1, 2])
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _seq(spec):
    return build_study(spec, CPU).run("sequential")

SMALL = dict(num_kernels=3, windows_per_kernel=2)
SPEC_A = {
    "workloads": [{"app": "pagerank", "graph": "arxiv", "scale": 0.4,
                   **SMALL}],
    "mechanisms": ["cpu", "lazypim"],
    "threads": 16,
}
SPEC_B = {
    "workloads": [{"app": "htap128", "scale": 0.004, **SMALL}],
    "mechanisms": ["cpu", "lazypim"],
    "threads": 16,
}
# Same geometry as SPEC_A but a 2-point hw axis: coalesces with it.
SPEC_A2 = {**SPEC_A, "hw_grid": {"offchip_bw_gbs": [16.0, 32.0]}}


def _server(clock=None, chaos=None, **cfg_kw):
    cfg_kw.setdefault("default_deadline_s", 1e9)
    cfg_kw.setdefault("coalesce", True)
    cfg_kw.setdefault("device", CPU)
    return StudyServer(ServeConfig(**cfg_kw), clock=clock or VirtualClock(),
                       chaos=chaos)


def _assert_rows_equal(a, b):
    ra, rb = a.to_rows(), b.to_rows()
    assert len(ra) == len(rb)
    for x, y in zip(ra, rb):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], float):
                np.testing.assert_array_equal(x[k], y[k]), k
            else:
                assert x[k] == y[k], k


# -- pure policy mechanics ---------------------------------------------------


def test_policy_config_validates_knobs():
    PolicyConfig()  # defaults are legal
    with pytest.raises(ValueError, match="formation_window_s"):
        PolicyConfig(formation_window_s=-0.1)
    with pytest.raises(ValueError, match="depth_threshold"):
        PolicyConfig(depth_threshold=0)
    with pytest.raises(ValueError, match="offender_threshold"):
        PolicyConfig(offender_threshold=0.0)
    with pytest.raises(ValueError, match="offender_decay"):
        PolicyConfig(offender_decay=1.0)
    with pytest.raises(ValueError, match="coalesce"):
        ServeConfig(adaptive=True, device=CPU)  # policy without the coalescer


def test_service_model_cold_start_is_greedy_and_learns_by_ema():
    m = ServiceModel()
    assert m.predict(64) == 0.0          # cold: never a spurious refusal
    m.observe(4, 1.0)
    assert m.predict(4) == 1.0
    assert m.predict(8) == 2.0           # linear-in-lanes above observed
    assert m.predict(1) == 1.0           # borrow the narrowest observed
    m.observe(4, 2.0)                    # EMA decays, never hard-resets
    assert abs(m.predict(4) - 1.2) < 1e-12


def test_slack_width_monotonically_shrinks_as_slack_tightens():
    p = AdaptivePolicy(PolicyConfig())
    for w in BLESSED_LANE_WIDTHS:
        p.model.observe(w, 0.1 * w)      # 1 lane ~ 0.1 s
    slacks = [1e9, 6.4, 3.2, 1.6, 0.8, 0.65, 0.4, 0.2, 0.1, 0.05, 0.0]
    widths = [p.width_budget(s) for s in slacks]
    assert widths[0] == BLESSED_LANE_WIDTHS[-1]
    assert widths[-1] == BLESSED_LANE_WIDTHS[0]  # never below the narrowest
    assert all(a >= b for a, b in zip(widths, widths[1:]))
    assert p.width_budget(0.65) == 4     # 0.4 s fits, 0.8 s does not


def test_offender_score_decays_back_to_batched_routing():
    p = AdaptivePolicy(PolicyConfig(offender_threshold=3.0,
                                    offender_decay=0.5))
    key = "group-key"
    assert not p.route_sequential(key)
    for _ in range(3):
        p.record_offense(key)
    assert p.route_sequential(key)
    p.record_clean(key)                  # 3.0 -> 1.5: healed enough
    assert not p.route_sequential(key)
    for _ in range(10):
        p.record_clean(key)
    assert key not in p.offenders        # fully decayed scores are dropped


def test_formation_window_decisions_and_slack_cap():
    p = AdaptivePolicy(PolicyConfig(formation_window_s=0.5,
                                    depth_threshold=4))
    kw = dict(lanes=1, lane_budget=64, min_slack_s=100.0)
    assert p.formation_window(depth=4, **kw) == 0.0   # deep queue
    assert p.formation_window(depth=0, **kw) == 0.0   # no backlog
    assert p.formation_window(depth=1, lanes=64, lane_budget=64,
                              min_slack_s=100.0) == 0.0  # group full
    assert p.formation_window(depth=1, **kw) == 0.5   # hold
    # slack caps the window below the configured length...
    assert p.formation_window(depth=1, lanes=1, lane_budget=64,
                              min_slack_s=0.2) == 0.2
    # ...and the predicted dispatch wall eats into the spare
    p.model.observe(1, 0.15)
    w = p.formation_window(depth=1, lanes=1, lane_budget=64,
                           min_slack_s=0.2)
    assert abs(w - 0.05) < 1e-12
    assert p.formation_window(depth=1, lanes=1, lane_budget=64,
                              min_slack_s=0.1) == 0.0  # cannot afford any
    d = p.telemetry.decisions
    assert d["immediate_deep_queue"] == 1 and d["immediate_no_backlog"] == 1
    assert d["immediate_group_full"] == 1 and d["immediate_slack"] == 1
    assert d["hold"] == 3


def test_telemetry_percentiles_and_summary():
    t = Telemetry()
    for lat in (0.1, 0.2, 0.3, 0.4):
        t.observe_response(types.SimpleNamespace(status="ok", latency_s=lat))
    t.observe_response(types.SimpleNamespace(status="timeout", latency_s=9.0))
    pct = t.latency_percentiles()
    assert pct["ok"] == {"n": 4, "p50_s": 0.2, "p99_s": 0.4}
    assert pct["timeout"] == {"n": 1, "p50_s": 9.0, "p99_s": 9.0}
    t.observe_depth(3)
    t.observe_depth(1)
    t.observe_width(4)
    s = t.summary()
    assert s["steps"] == 2
    assert s["queue_depth"] == {"max": 3, "mean": 2.0}
    assert s["dispatch_widths"] == {4: 1}


# -- satellite: audit-sample 1-lane floor ------------------------------------


@pytest.mark.parametrize("lanes", list(range(1, 9)))
def test_audit_sample_floors_at_one_lane(lanes):
    # The rounding regression this pins: a truncating
    # ``int(lanes * fraction)`` sample size is ZERO for lanes <= 3 at the
    # default fraction 0.25 — small coalesced groups (and every
    # post-bisection sub-batch) would ship entirely unaudited.
    for fraction in (0.25, 0.1, 0.01):
        s = audit_sample(0, 3, lanes, fraction)
        assert len(s) >= 1, (lanes, fraction)
        assert len(s) == min(lanes, max(1, int(np.ceil(lanes * fraction))))
        assert all(0 <= i < lanes for i in s) and sorted(set(s)) == s
    assert audit_sample(0, 3, lanes, 0.0) == []  # audit off stays off


# -- satellite: deadline_s falsy-sentinel fix --------------------------------


def test_deadline_zero_rejected_not_silently_defaulted():
    # Pre-fix, ``deadline_s or default`` silently served a ``0.0``
    # deadline under the 300 s default; now it is API misuse by name.
    srv = _server()
    with pytest.raises(ValueError, match="deadline_s"):
        srv.submit(SPEC_A, deadline_s=0.0)
    with pytest.raises(ValueError, match="deadline_s"):
        srv.submit(SPEC_A, deadline_s=-5.0)
    # Rejected before admission: no rid consumed, nothing queued.
    assert srv._next_rid == 0 and len(srv.queue) == 0
    assert isinstance(srv.submit(SPEC_A), int)  # None -> default, fine


def test_explicit_deadline_honored_on_fake_clock():
    clock = VirtualClock()
    srv = _server(clock=clock, default_deadline_s=300.0)
    rid = srv.submit(SPEC_A, deadline_s=5.0)
    assert isinstance(rid, int)
    clock.advance(6.0)  # past the explicit deadline, well inside default
    (r,) = srv.drain()
    assert r.status == TIMEOUT and r.rid == rid


# -- satellite: formation-timeout members leave no stale journal -------------


def test_formation_timeout_clears_journal_no_stale_replay(tmp_path):
    clock = VirtualClock()
    srv = _server(clock=clock, cache_dir=str(tmp_path),
                  default_deadline_s=300.0)
    r1 = srv.submit(SPEC_A, deadline_s=5.0)
    r2 = srv.submit(SPEC_A, deadline_s=5.0)
    assert set(srv._journal) == {r1, r2}
    clock.advance(6.0)  # both expire between BoundedQueue.take and dispatch
    out = srv.drain()
    assert {r.rid: r.status for r in out} == {r1: TIMEOUT, r2: TIMEOUT}
    # The timeout resolved through _resolve, so the journal is clean on
    # disk too: a restarted server must NOT re-answer them as in-flight.
    assert srv._journal == {}
    data = json.loads((tmp_path / "journal.json").read_text())
    assert data["inflight"] == {}
    srv2, replayed = restart_server(
        ServeConfig(default_deadline_s=300.0, coalesce=True,
                    cache_dir=str(tmp_path), device=CPU), clock=VirtualClock())
    assert replayed == []


# -- formation window through the server loop --------------------------------


def test_no_hold_at_depth_one_or_deep_queue():
    clock = VirtualClock()
    srv = _server(clock=clock, adaptive=True, formation_window_s=60.0,
                  depth_threshold=4)
    # depth 1 (no backlog behind the head): immediate, zero added latency
    srv.submit(SPEC_A)
    (r,) = srv.step()
    assert r.status == OK and clock.slept == 0.0
    assert srv.telemetry.decisions["immediate_no_backlog"] == 1
    # deep queue (backlog >= threshold): the greedy path
    rids = [srv.submit(SPEC_A) for _ in range(5)]
    out = srv.step()
    assert [r.status for r in out] == [OK] * 5
    assert {r.rid for r in out} == set(rids)
    assert srv.telemetry.decisions["immediate_deep_queue"] == 1
    assert srv.stats["formation_holds"] == 0 and clock.slept == 0.0


def test_hold_lets_midwindow_peers_share_one_dispatch():
    clock = VirtualClock()
    srv = _server(clock=clock, adaptive=True, formation_window_s=10.0,
                  depth_threshold=4)
    a = srv.submit(SPEC_A)
    b = srv.submit(SPEC_B)        # incompatible backlog: the load signal
    assert srv.step() == []       # head held for formation
    assert srv.stats["formation_holds"] == 1
    a2 = srv.submit(SPEC_A2)      # arrives mid-window, joins the held group
    out = []
    while len(out) < 3:
        r = srv.step()
        assert r is not None
        out.extend(r)
    st = {r.rid: r for r in out}
    assert st[a].status == OK and st[a2].status == OK and st[b].status == OK
    # a and a2 shared ONE dispatch (3 lanes -> blessed width 4); b rode its
    # own 1-lane dispatch afterward.
    assert srv.stats["coalesced_dispatches"] == 2
    assert srv.telemetry.dispatch_widths == [4, 1]
    _assert_rows_equal(st[a].results, _seq(SPEC_A))
    _assert_rows_equal(st[a2].results, _seq(SPEC_A2))


def test_hold_never_outlives_member_slack():
    clock = VirtualClock()
    srv = _server(clock=clock, adaptive=True, formation_window_s=50.0,
                  depth_threshold=4, default_deadline_s=300.0)
    srv.policy.model.observe(1, 2.0)   # a dispatch costs ~2 virtual s
    srv.policy.model.observe(64, 2.0)
    a = srv.submit(SPEC_A, deadline_s=10.0)  # slack 10 - predicted 2 = 8
    b = srv.submit(SPEC_B)
    assert srv.step() == []
    # the window was capped at the spare slack, not the configured 50 s
    assert srv._held.hold_until - clock.now() <= 8.0 + 1e-9
    out = srv.drain()
    st = {r.rid: r.status for r in out}
    assert st[a] == OK and st[b] == OK   # served, never timed out
    assert clock.slept <= 8.0 + 1e-9


def test_tight_slack_arrival_shortens_open_hold():
    clock = VirtualClock()
    srv = _server(clock=clock, adaptive=True, formation_window_s=60.0,
                  depth_threshold=4)
    a = srv.submit(SPEC_A)
    b = srv.submit(SPEC_B)
    assert srv.step() == []              # held with a ~60 s window
    a2 = srv.submit(SPEC_A, deadline_s=3.0)  # tight joiner
    out = []
    while len(out) < 3:
        r = srv.step()
        assert r is not None
        out.extend(r)
    st = {r.rid: (r.status, r.engine) for r in out}
    assert st[a] == (OK, "coalesced") and st[a2] == (OK, "coalesced")
    assert clock.slept <= 3.0 + 1e-9     # window cut to the joiner's slack
    assert srv.stats["formation_holds"] == 1


def test_unaffordable_slack_skips_the_hold_entirely():
    clock = VirtualClock()
    srv = _server(clock=clock, adaptive=True, formation_window_s=50.0,
                  depth_threshold=4, default_deadline_s=300.0)
    srv.policy.model.observe(1, 2.0)
    a = srv.submit(SPEC_A, deadline_s=1.5)   # slack < predicted dispatch
    srv.submit(SPEC_B)
    out = srv.step()                         # no hold: dispatch now
    assert out != [] and out[0].rid == a and out[0].status == OK
    assert srv.telemetry.decisions["immediate_slack"] == 1
    assert srv.stats["formation_holds"] == 0 and clock.slept == 0.0


# -- slack-driven width through the server loop ------------------------------


def test_slack_caps_group_width_tight_members_split_the_queue():
    clock = VirtualClock()
    srv = _server(clock=clock, adaptive=True, formation_window_s=0.0,
                  depth_threshold=1)   # isolate the width decision
    # Fitted model: a 4-lane dispatch is cheap, an 8-lane one is not.
    srv.policy.model.observe(4, 1.0)
    srv.policy.model.observe(8, 100.0)
    rids = [srv.submit(SPEC_A, deadline_s=10.0) for _ in range(6)]
    out = srv.drain()
    assert {r.rid: r.status for r in out} == {rid: OK for rid in rids}
    # Greedy would stack all 6 lanes into one width-8 dispatch; the
    # slack cap (10 s cannot afford the predicted 100 s at width 8)
    # splits the queue into a 4-lane group and a 2-lane remainder.
    assert srv.telemetry.dispatch_widths == [4, 2]
    assert srv.telemetry.decisions["width_capped"] >= 1


def test_cold_model_stays_greedy_full_width():
    clock = VirtualClock()
    srv = _server(clock=clock, adaptive=True, formation_window_s=0.0,
                  depth_threshold=1)
    rids = [srv.submit(SPEC_A, deadline_s=10.0) for _ in range(6)]
    out = srv.drain()
    assert {r.rid: r.status for r in out} == {rid: OK for rid in rids}
    assert srv.telemetry.dispatch_widths == [8]  # one greedy dispatch


# -- repeat-offender routing through the server loop -------------------------


def test_repeat_offender_routes_sequential_then_heals():
    clock = VirtualClock()
    srv = _server(clock=clock, adaptive=True)
    key = group_key(build_study(SPEC_A, CPU))
    for _ in range(3):
        srv.policy.record_offense(key)
    ref = _seq(SPEC_A)
    srv.submit(SPEC_A)
    (r,) = srv.drain()
    assert r.status == OK_DEGRADED and r.engine == "sequential"
    assert "repeat-offender" in r.error
    assert srv.stats["offender_routed"] == 1
    _assert_rows_equal(r.results, ref)   # a detour is never a wrong answer
    # The clean routed serve decayed the score below threshold: the key
    # heals back to batched routing on its own.
    srv.submit(SPEC_A)
    (r2,) = srv.drain()
    assert r2.status == OK and r2.engine == "coalesced"
    assert srv.stats["offender_routed"] == 1


class _FinitePoisonAll(ChaosMonkey):
    """Finitely corrupts every lane of every coalesced dispatch — the
    chronically audit-failing group key the offender score exists for."""

    def corrupt_accs(self, lane_slices, accs):
        accs = {m: {k: np.array(v) for k, v in fields.items()}
                for m, fields in accs.items()}
        for fields in accs.values():
            fields["time_ns"] = fields["time_ns"] * 1.5
        return accs


def test_audit_mismatches_drive_offender_routing():
    clock = VirtualClock()
    monkey = _FinitePoisonAll(ChaosConfig(seed=0, fault_rate=0.0),
                              clock=clock)
    srv = _server(clock=clock, chaos=monkey, adaptive=True,
                  audit_fraction=1.0, offender_threshold=3.0)
    ref = _seq(SPEC_A)
    outcomes = []
    for _ in range(4):
        srv.submit(SPEC_A)
        (r,) = srv.drain()
        outcomes.append((r.status, r.engine))
        _assert_rows_equal(r.results, ref)
    # Three audit-mismatch degradations accumulate the score; the fourth
    # request skips the doomed batched dispatch entirely.
    assert outcomes == [(OK_DEGRADED, "sequential")] * 4
    assert srv.stats["audit_mismatches"] == 3
    assert srv.stats["offender_routed"] == 1


# -- policy transparency under chaos (3-seed matrix leg) ---------------------


def _formation_storm(pkg, seed, n=12):
    """The formation storm through one package: a seeded arrival storm
    (``ChaosMonkey.burst``) landing submissions inside open formation
    windows.  Returns (final responses by rid, server, monkey)."""
    clock = pkg["VirtualClock"]()
    monkey = pkg["ChaosMonkey"](pkg["ChaosConfig"](
        seed=seed, fault_rate=0.3,
        classes=("malformed_spec", "oversized", "poison_lane",
                 "poison_result")), clock=clock)
    srv = pkg["StudyServer"](pkg["ServeConfig"](
        default_deadline_s=1e9, coalesce=True, audit_fraction=1.0, seed=seed,
        adaptive=True, formation_window_s=0.01, depth_threshold=4,
        offender_threshold=1e9, **pkg["cfg_kw"]),  # isolate formation/width policy
        clock=clock, chaos=monkey)
    storm = pkg["make_storm"](monkey, n, [SPEC_A])
    pending = list(storm)
    final = {}
    for tick in range(300):
        for _ in range(monkey.burst(tick, 3)):
            if pending:
                out = srv.submit(pending.pop(0))
                if not isinstance(out, int):
                    final[out.rid] = out
        r = srv.step()
        for resp in (r if isinstance(r, list) else [r] if r else []):
            final[resp.rid] = resp
        if (not pending and srv._held is None and len(srv.queue) == 0
                and len(final) == n):
            break
    return final, srv, monkey


TORCH = dict(ChaosConfig=ChaosConfig, ChaosMonkey=ChaosMonkey, ServeConfig=ServeConfig,
             StudyServer=StudyServer, VirtualClock=VirtualClock, make_storm=make_storm,
             cfg_kw=dict(device=CPU))
JAX = dict(ChaosConfig=RChaosConfig, ChaosMonkey=RChaosMonkey, ServeConfig=RServeConfig,
           StudyServer=RStudyServer, VirtualClock=RVirtualClock, make_storm=r_make_storm,
           cfg_kw={})


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_resolutions_policy_transparent_under_formation_storm(seed):
    """Every fault-class resolution from the contract table holds
    unchanged with the adaptive policy on, while a seeded arrival storm
    (ChaosMonkey.burst) lands submissions *inside* open formation
    windows: rejects stay rejects, poisons stay quarantined, finite
    corruption is still caught by the audit, healthy members still get
    bit-exact answers."""
    n = 12
    final, srv, monkey = _formation_storm(TORCH, seed, n)
    assert len(final) == n, f"storm did not resolve: {sorted(final)}"
    faults = {rid: monkey.fault_for(rid) for rid in range(n)}
    injected = dict(monkey.injected)
    ref = _seq(SPEC_A)
    for rid in range(n):
        r, f = final[rid], faults[rid]
        if f == "malformed_spec":
            assert r.status == REJECTED_MALFORMED, (rid, r.status)
        elif f == "oversized":
            assert r.status == REJECTED_OVERSIZED, (rid, r.status)
        elif f == "poison_lane":
            assert r.status == QUARANTINED, (rid, r.status, r.error)
            assert rid in srv.quarantine
        elif f == "poison_result":
            if injected.get(rid) == "poison_result:nan":
                assert r.status == QUARANTINED, (rid, r.status)
            else:
                assert r.status in SERVED, (rid, r.status, r.error)
                _assert_rows_equal(r.results, ref)
        else:
            assert r.status in SERVED, (rid, r.status, r.error)
            _assert_rows_equal(r.results, ref)


def test_adaptive_answers_bit_exact_with_greedy_coalescer():
    specs = [SPEC_A, SPEC_B, SPEC_A2, SPEC_A, SPEC_B, SPEC_A]

    def run(adaptive):
        srv = _server(adaptive=adaptive, formation_window_s=5.0,
                      depth_threshold=3)
        rids = [srv.submit(s) for s in specs]
        assert all(isinstance(r, int) for r in rids)
        return {r.rid: r for r in srv.drain()}

    greedy, adaptive = run(False), run(True)
    assert set(greedy) == set(adaptive)
    for rid in greedy:
        assert greedy[rid].status == OK and adaptive[rid].status == OK
        _assert_rows_equal(greedy[rid].results, adaptive[rid].results)


def test_burst_draw_is_deterministic_and_bounded():
    m = ChaosMonkey(ChaosConfig(seed=7))
    xs = [m.burst(t, 3) for t in range(64)]
    assert xs == [ChaosMonkey(ChaosConfig(seed=7)).burst(t, 3)
                  for t in range(64)]
    assert all(0 <= x <= 3 for x in xs)
    assert len(set(xs)) > 1              # actually varies across ticks
    assert m.burst(0, 0) == 0
    with pytest.raises(ValueError):
        m.burst(0, -1)


# -- held to repro -----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_decisions_equal_reference(seed):
    """The same observations through both packages' policy: every width
    budget, hold spare, formation window, offender verdict and telemetry
    summary equal."""
    rng = np.random.default_rng(seed)
    kw = dict(formation_window_s=0.5, depth_threshold=4, offender_threshold=2.0,
              offender_decay=0.5)
    t, r = AdaptivePolicy(PolicyConfig(**kw)), RAdaptivePolicy(RPolicyConfig(**kw))
    for _ in range(200):
        op = rng.integers(0, 5)
        if op == 0:
            w, wall = int(rng.choice(BLESSED_LANE_WIDTHS)), float(rng.exponential(0.3))
            t.model.observe(w, wall)
            r.model.observe(w, wall)
        elif op == 1:
            key = int(rng.integers(0, 3))
            offense = rng.random() < 0.5
            for p in (t, r):
                (p.record_offense if offense else p.record_clean)(key)
            assert t.offenders == r.offenders
            assert t.route_sequential(key) == r.route_sequential(key)
        slack = float(rng.exponential(1.0))
        assert t.width_budget(slack) == r.width_budget(slack)
        assert t.hold_spare(slack) == r.hold_spare(slack)
        fw = dict(depth=int(rng.integers(0, 6)), lanes=int(rng.integers(1, 65)),
                  lane_budget=64, min_slack_s=slack)
        assert t.formation_window(**fw) == r.formation_window(**fw)
    assert t.telemetry.summary() == r.telemetry.summary()
    tt, rt = Telemetry(), RTelemetry()
    for _ in range(100):
        resp = types.SimpleNamespace(status=str(rng.choice(["ok", "timeout"])),
                                     latency_s=float(rng.exponential(1.0)))
        depth, width = int(rng.integers(0, 9)), int(rng.choice(BLESSED_LANE_WIDTHS))
        for x in (tt, rt):
            x.observe_response(resp)
            x.observe_depth(depth)
            x.observe_width(width)
    assert tt.summary() == rt.summary()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_formation_storm_outcomes_equal_reference(seed):
    got, srv, _ = _formation_storm(TORCH, seed)
    want, ref, _ = _formation_storm(JAX, seed)
    assert sorted(got) == sorted(want)
    for rid, b in want.items():
        a = got[rid]
        assert (a.status, a.engine) == (b.status, b.engine), rid
        if b.results is not None:
            assert a.results.to_rows() == b.results.to_rows(), rid
    assert srv.telemetry.summary() == ref.telemetry.summary()
    assert srv.stats == ref.stats
