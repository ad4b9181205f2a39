"""The port's fault-tolerance primitives (``repro_torch.runtime
.fault_tolerance``), mirroring ``tests/test_fault_tolerance.py``: empty
monitors, simultaneous deaths, the remove_host restart path (the
forever-dead poisoning regression), and straggler strike resets; then the
port's copy held to ``repro``'s on the same observation sequences (heartbeat
verdicts, straggler flags, restart plans, re-mesh shapes), exactly."""

import numpy as np
import pytest

from repro.runtime import fault_tolerance as RF
from repro_torch.runtime import fault_tolerance as TF
from repro_torch.runtime.fault_tolerance import (
    HeartbeatMonitor,
    RestartPolicy,
    StragglerDetector,
)

# -- HeartbeatMonitor --------------------------------------------------------


def test_empty_monitor_reports_nothing():
    hb = HeartbeatMonitor(timeout_s=10)
    assert hb.dead_hosts(now=1e9) == []
    assert hb.min_step() == 0


def test_remove_unknown_host_is_noop():
    hb = HeartbeatMonitor(timeout_s=10)
    hb.remove_host(7)  # a host may die before its first beat
    assert hb.dead_hosts(now=0.0) == []


def test_simultaneous_deaths_all_reported():
    hb = HeartbeatMonitor(timeout_s=10)
    for h in range(4):
        hb.beat(h, step=5, now=0.0)
    hb.beat(3, step=6, now=50.0)
    assert sorted(hb.dead_hosts(now=50.0)) == [0, 1, 2]


def test_remove_host_unpoisons_the_monitor():
    # The regression remove_host fixes: a handled death must be forgotten,
    # or it re-flags on every later check and clamps min_step forever.
    hb = HeartbeatMonitor(timeout_s=10)
    hb.beat(0, step=2, now=0.0)
    hb.beat(1, step=9, now=100.0)
    assert hb.dead_hosts(now=100.0) == [0]
    assert hb.min_step() == 2  # dead host clamps global progress
    hb.remove_host(0)
    assert hb.dead_hosts(now=100.0) == []
    assert hb.min_step() == 9
    # A replacement incarnation can re-join under the same host id.
    hb.beat(0, step=9, now=101.0)
    assert hb.dead_hosts(now=101.0) == []


def test_remove_all_dead_after_mass_failure():
    hb = HeartbeatMonitor(timeout_s=10)
    for h in range(3):
        hb.beat(h, step=1, now=0.0)
    for h in hb.dead_hosts(now=99.0):
        hb.remove_host(h)
    assert hb.dead_hosts(now=99.0) == []
    assert hb.min_step() == 0  # back to the empty-monitor baseline


# -- StragglerDetector -------------------------------------------------------


def _observe_round(sd, slow_host_latency):
    sd.observe(0, 1.0)
    sd.observe(1, 1.0)
    sd.observe(2, slow_host_latency)
    return sd.stragglers()


def test_straggler_needs_patience_consecutive_strikes():
    sd = StragglerDetector(straggler_factor=1.5, patience=3, ewma=1.0)
    assert _observe_round(sd, 10.0) == []
    assert _observe_round(sd, 10.0) == []
    assert _observe_round(sd, 10.0) == [2]


def test_straggler_strike_reset_on_recovery():
    # Two strikes, then a fast round: the strike counter resets to zero and
    # the host needs the full patience window again before being flagged.
    sd = StragglerDetector(straggler_factor=1.5, patience=3, ewma=1.0)
    _observe_round(sd, 10.0)
    _observe_round(sd, 10.0)
    assert _observe_round(sd, 1.0) == []
    assert sd._strikes[2] == 0
    _observe_round(sd, 10.0)
    assert _observe_round(sd, 10.0) == []  # only 2 strikes since reset


def test_straggler_single_host_never_flagged():
    sd = StragglerDetector(patience=1)
    sd.observe(0, 100.0)
    assert sd.stragglers() == []  # no peers, no median, no verdict


# -- RestartPolicy -----------------------------------------------------------


def test_restart_policy_no_deaths_is_none():
    rp = RestartPolicy(total_devices=8, min_devices=4)
    assert rp.plan([]) == {"action": "none"}


def test_restart_policy_halts_below_min():
    rp = RestartPolicy(total_devices=8, min_devices=8)
    plan = rp.plan([0], devices_per_host=4)
    assert plan["action"] == "halt"
    assert plan["surviving"] == 4


def test_restart_policy_remesh_keeps_surviving_devices():
    rp = RestartPolicy(total_devices=8, min_devices=4)
    plan = rp.plan([0], devices_per_host=4)
    assert plan["action"] == "remesh"
    assert plan["surviving"] == 4
    shape, _ = plan["mesh_shape"], plan["mesh_axes"]
    prod = 1
    for d in shape:
        prod *= d
    assert prod == 4


# -- the port's copy against repro's ----------------------------------------


def test_degraded_mesh_shape_equals_reference():
    for n in range(1, 2049):
        assert TF.degraded_mesh_shape(n) == RF.degraded_mesh_shape(n), n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_restart_plans_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        total = int(rng.integers(1, 1025))
        kw = dict(total_devices=total, min_devices=int(rng.integers(1, total + 1)))
        dead = sorted(set(rng.integers(0, 64, int(rng.integers(0, 8))).tolist()))
        per_host = int(rng.choice([1, 2, 4, 8]))
        assert TF.RestartPolicy(**kw).plan(dead, per_host) == \
            RF.RestartPolicy(**kw).plan(dead, per_host)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_monitor_and_stragglers_follow_reference(seed):
    """The same beats, removals and latencies through both packages' monitor
    and detector give the same dead hosts, minimum step, EWMAs and
    straggler verdicts at every step."""
    rng = np.random.default_rng(seed)
    t_hb, r_hb = TF.HeartbeatMonitor(timeout_s=5.0), RF.HeartbeatMonitor(timeout_s=5.0)
    kw = dict(straggler_factor=1.5, patience=2, ewma=0.5)
    t_sd, r_sd = TF.StragglerDetector(**kw), RF.StragglerDetector(**kw)
    now = 0.0
    for step in range(300):
        now += float(rng.exponential(1.0))
        host = int(rng.integers(0, 6))
        if rng.random() < 0.1:
            t_hb.remove_host(host)
            r_hb.remove_host(host)
        else:
            t_hb.beat(host, step, now=now)
            r_hb.beat(host, step, now=now)
        lat = float(rng.lognormal(0.0, 0.6)) * (3.0 if host == 5 else 1.0)
        t_sd.observe(host, lat)
        r_sd.observe(host, lat)
        assert t_hb.dead_hosts(now=now) == r_hb.dead_hosts(now=now)
        assert t_hb.min_step() == r_hb.min_step()
        assert t_sd.stragglers() == r_sd.stragglers()
        assert t_sd._lat == r_sd._lat
