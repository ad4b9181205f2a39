"""Chaos storms against the port's resident study server on the CPU,
mirroring ``tests/test_serve_chaos.py``: every injected fault class must
resolve to exactly one of {reject, retry-success, degrade, timeout, clean
restart} — never a wrong result, never a silent drop — and storms replay
bit for bit per seed.  Set ``REPRO_CHAOS_SEED`` to pin a single seed.

Held to ``repro`` itself: the monkey's per-rid draws bit for bit over a
grid of seeds, rids and ticks; for seeds 0, 1 and 2, ``make_storm`` yields
the reference's specs, and each rid of the crash storm resolves with the
reference server's (status, engine, attempts, restarted) and its
``to_rows()`` — exactly, the simulator being bit-exact across packages."""

import functools
import os

import numpy as np
import pytest
import torch

from repro.serve import ChaosConfig as RChaosConfig
from repro.serve import ChaosMonkey as RChaosMonkey
from repro.serve import ServeConfig as RServeConfig
from repro.serve import StudyServer as RStudyServer
from repro.serve import VirtualClock as RVirtualClock
from repro.serve import make_storm as r_make_storm
from repro.serve import restart_server as r_restart_server
from repro_torch.serve import (
    ALL_FAULT_CLASSES,
    CRASHED,
    FAULT_CLASSES,
    OK,
    OK_DEGRADED,
    REJECTED_MALFORMED,
    REJECTED_OVERSIZED,
    TIMEOUT,
    ChaosConfig,
    ChaosMonkey,
    ServeConfig,
    StudyServer,
    VirtualClock,
    build_study,
    make_storm,
    restart_server,
)

SMALL = dict(num_kernels=3, windows_per_kernel=2)
BASE_SPECS = [
    {"workloads": [{"app": "pagerank", "graph": "arxiv", "scale": 0.4,
                    **SMALL}],
     "mechanisms": ["cpu", "lazypim"], "threads": 16},
    {"workloads": [{"app": "htap128", "scale": 0.004, **SMALL}],
     "mechanisms": ["cpu", "lazypim"], "threads": 16},
]

SEEDS = ([int(os.environ["REPRO_CHAOS_SEED"])]
         if "REPRO_CHAOS_SEED" in os.environ else [0, 1, 2])
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _base_rows(i):
    return build_study(BASE_SPECS[i], CPU).run("sequential").to_rows()


def _reference_rows(rid):
    """Fault-free sequential-engine answer for the storm's rid-th request."""
    return _base_rows(rid % len(BASE_SPECS))


def _assert_right_answer(resp):
    """A served response (degraded or not, replayed or not) must be
    bit-exact with the fault-free sequential reference."""
    got = resp.results.to_rows()
    want = _reference_rows(resp.rid)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        for k in x:
            if isinstance(x[k], float):
                np.testing.assert_array_equal(x[k], y[k])
            else:
                assert x[k] == y[k]


def _run_storm(seed, classes, n=16, fault_rate=0.6):
    clock = VirtualClock()
    monkey = ChaosMonkey(
        ChaosConfig(seed=seed, fault_rate=fault_rate, classes=classes,
                    hang_s=60.0),
        clock=clock)
    # Deadlines are effectively infinite so one request's 60s hang doesn't
    # eat the deadline budget of everything queued behind it (the hang
    # itself is caught by the heartbeat monitor, not the deadline; deadline
    # expiry has its own test in test_serve.py).
    cfg = ServeConfig(default_deadline_s=1e9, heartbeat_timeout_s=20.0,
                      backoff_base_s=0.01, max_queue=n, max_lanes=64, device=CPU)
    srv = StudyServer(cfg, clock=clock, chaos=monkey)
    for spec in make_storm(monkey, n, BASE_SPECS):
        srv.submit(spec)
    srv.drain()
    return srv, monkey, clock


EXPECT = {
    None: OK,
    "malformed_spec": REJECTED_MALFORMED,
    "oversized": REJECTED_OVERSIZED,
    "hang": TIMEOUT,
}


@pytest.mark.parametrize("seed", SEEDS)
def test_every_fault_class_resolves_as_required(seed):
    classes = ("malformed_spec", "oversized", "engine_exception", "hang")
    srv, monkey, _ = _run_storm(seed, classes)
    assert len(srv.responses) == 16  # one terminal response per request
    for rid, resp in srv.responses.items():
        kind = monkey.fault_for(rid)
        if kind == "engine_exception":
            if monkey.is_transient(rid):
                assert resp.status == OK and resp.attempts == 2, rid
            else:
                assert resp.status == OK_DEGRADED, rid
                assert resp.engine == "sequential"
        else:
            assert resp.status == EXPECT[kind], (rid, kind)
        if resp.served:
            _assert_right_answer(resp)  # zero wrong results, ever
    # The storm actually exercised multiple fault classes at this seed.
    hit = {monkey.fault_for(r) for r in range(16)} - {None}
    assert len(hit) >= 3, f"seed {seed} storm too quiet: {hit}"


@pytest.mark.parametrize("seed", SEEDS)
def test_storm_is_bit_reproducible(seed):
    classes = ("malformed_spec", "oversized", "engine_exception", "hang")
    a, _, ca = _run_storm(seed, classes)
    b, _, cb = _run_storm(seed, classes)
    assert {r: v.status for r, v in a.responses.items()} == \
        {r: v.status for r, v in b.responses.items()}
    assert {r: v.attempts for r, v in a.responses.items()} == \
        {r: v.attempts for r, v in b.responses.items()}
    assert ca.slept == cb.slept  # identical backoff + hang timeline


def _crash_storm(pkg, seed, cache_dir, n=12):
    """The crash storm through one package's server (``pkg``: its
    ``ChaosConfig``, ``ChaosMonkey``, ``ServeConfig``, ``StudyServer``,
    ``VirtualClock``, ``make_storm`` and ``restart_server``, and the config's
    extra keywords).  Returns (final responses by rid, monkey, restarts)."""
    clock = pkg["VirtualClock"]()
    monkey = pkg["ChaosMonkey"](
        pkg["ChaosConfig"](seed=seed, fault_rate=0.6, hang_s=60.0), clock=clock)
    cfg = pkg["ServeConfig"](default_deadline_s=1e9, heartbeat_timeout_s=20.0,
                             backoff_base_s=0.01, max_queue=n, max_lanes=64,
                             cache_dir=str(cache_dir), **pkg["cfg_kw"])
    srv = pkg["StudyServer"](cfg, clock=clock, chaos=monkey)
    final = {}
    for spec in pkg["make_storm"](monkey, n, BASE_SPECS):
        out = srv.submit(spec)
        if not isinstance(out, int):
            final[out.rid] = out  # admission reject is already terminal
    for r in srv.drain():
        final[r.rid] = r

    restarts = 0
    while srv.crashed:
        restarts += 1
        assert restarts <= n, "restart loop did not converge"
        srv, replayed = pkg["restart_server"](cfg, clock=clock, chaos=monkey)
        for r in replayed:
            assert r.restarted
            final[r.rid] = r
        for r in srv.drain():
            final[r.rid] = r
    return final, monkey, restarts


TORCH = dict(ChaosConfig=ChaosConfig, ChaosMonkey=ChaosMonkey, ServeConfig=ServeConfig,
             StudyServer=StudyServer, VirtualClock=VirtualClock, make_storm=make_storm,
             restart_server=restart_server, cfg_kw=dict(device=CPU))
JAX = dict(ChaosConfig=RChaosConfig, ChaosMonkey=RChaosMonkey, ServeConfig=RServeConfig,
           StudyServer=RStudyServer, VirtualClock=RVirtualClock, make_storm=r_make_storm,
           restart_server=r_restart_server, cfg_kw={})


@pytest.mark.parametrize("seed", SEEDS)
def test_crash_storm_recovers_with_no_silent_drops(seed, tmp_path):
    n = 12
    final, monkey, restarts = _crash_storm(TORCH, seed, tmp_path / f"seed{seed}", n)

    # Exactly one terminal, non-crashed response per request — a crash is
    # never an answer, only a handoff to the restarted server.
    assert sorted(final) == list(range(n))
    assert all(r.status != CRASHED for r in final.values())
    crashed_rids = [rid for rid in range(n)
                    if monkey.fault_for(rid) == "crash"]
    if crashed_rids:
        assert restarts >= 1
        for rid in crashed_rids:
            assert final[rid].status == OK and final[rid].restarted, rid
    for r in final.values():
        if r.served:
            _assert_right_answer(r)


# -- held to repro -----------------------------------------------------------


def test_monkey_draws_equal_reference():
    classes = ALL_FAULT_CLASSES
    for seed in (0, 1, 2, 11, 2**32 + 9):
        kw = dict(seed=seed, fault_rate=0.4, classes=classes)
        t, r = ChaosMonkey(ChaosConfig(**kw)), RChaosMonkey(RChaosConfig(**kw))
        for rid in (*range(64), 2**31 + 3, 2**32 - 1):
            assert t.fault_for(rid) == r.fault_for(rid), (seed, rid)
            assert t.is_transient(rid) == r.is_transient(rid), (seed, rid)
            assert t.variant(rid, 4) == r.variant(rid, 4), (seed, rid)
            assert t.variant(rid, 2) == r.variant(rid, 2), (seed, rid)
        for tick in range(64):
            assert t.burst(tick, 3) == r.burst(tick, 3), (seed, tick)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_storm_equals_reference(seed):
    for classes in (FAULT_CLASSES, ALL_FAULT_CLASSES):
        kw = dict(seed=seed, fault_rate=0.3, classes=classes)
        got = make_storm(ChaosMonkey(ChaosConfig(**kw)), 64, BASE_SPECS)
        want = r_make_storm(RChaosMonkey(RChaosConfig(**kw)), 64, BASE_SPECS)
        assert got == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crash_storm_outcomes_equal_reference(seed, tmp_path):
    got, _, got_restarts = _crash_storm(TORCH, seed, tmp_path / "torch")
    want, _, want_restarts = _crash_storm(JAX, seed, tmp_path / "jax")
    assert got_restarts == want_restarts
    assert sorted(got) == sorted(want)
    for rid in sorted(want):
        a, b = got[rid], want[rid]
        assert (a.status, a.engine, a.attempts, a.restarted) == \
            (b.status, b.engine, b.attempts, b.restarted), rid
        if b.results is not None:
            assert a.results.to_rows() == b.results.to_rows(), rid
