"""The port's resident study service on the CPU, mirroring
``tests/test_serve.py``: admission control, backpressure, retry/backoff,
deadline + hang cancellation, graceful degradation (bit-exact with the
sequential engine), warm-manifest round-trips, and crash-safe restart —
in the port's terms, a restarted server that warmed from its manifest
answers a repeat study with zero ``nvcc`` builds and zero new library
binds, shown through a stand-in compiler and library
(``tests/_bloom_standin.py``) on the port's real build and bind code.

Held to ``repro`` itself: the backoff draws bit for bit, a served study's
answer and the warm-manifest rows it writes.  The port's own interface:
``ServeConfig.device`` (``None``: the CUDA card), ``devices`` above the
visible count refused at boot, ``enable_persistent_cache`` reporting the
build directory.
"""

import json

import numpy as np
import pytest
import torch

import _bloom_standin as standin
from repro.serve import RetryPolicy as RRetryPolicy
from repro.serve import ServeConfig as RServeConfig
from repro.serve import StudyServer as RStudyServer
from repro.serve import VirtualClock as RVirtualClock
from repro_torch.kernels import _build
from repro_torch.kernels.bloom import bloom as K
from repro_torch.serve import (
    OK,
    OK_DEGRADED,
    REJECTED_MALFORMED,
    REJECTED_OVERLOAD,
    REJECTED_OVERSIZED,
    TIMEOUT,
    BoundedQueue,
    ChaosConfig,
    ChaosMonkey,
    RetryPolicy,
    ServeConfig,
    StudyServer,
    VirtualClock,
    WallClock,
    WarmCache,
    build_study,
    enable_persistent_cache,
    restart_server,
)
from repro_torch.sim.mesh import MESH_ENV_VAR
from repro_torch.sim.study import Study

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SMALL = dict(num_kernels=3, windows_per_kernel=2)
SPEC = {
    "workloads": [{"app": "pagerank", "graph": "arxiv", "scale": 0.4,
                   **SMALL}],
    "mechanisms": ["cpu", "lazypim"],
    "threads": 16,
}


def _server(clock=None, chaos=None, **cfg_kw):
    cfg_kw.setdefault("default_deadline_s", 1e9)
    cfg_kw.setdefault("device", CPU)
    return StudyServer(ServeConfig(**cfg_kw), clock=clock or VirtualClock(),
                       chaos=chaos)


def _reference():
    return build_study(SPEC, CPU).run("sequential")


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


# -- clocks and queue --------------------------------------------------------


def test_virtual_clock_sleep_advances():
    c = VirtualClock()
    t0 = c.now()
    c.sleep(2.5)
    c.advance(1.0)
    assert c.now() == t0 + 3.5
    assert c.slept == 2.5  # advance() is ambient time, not a sleep


def test_wall_clock_is_monotonic():
    c = WallClock()
    assert c.now() <= c.now()


def test_bounded_queue_sheds_when_full():
    q = BoundedQueue(2)
    assert q.offer("a") and q.offer("b")
    assert not q.offer("c")
    assert q.shed == 1 and q.accepted == 2 and len(q) == 2
    assert q.pop() == "a"
    assert q.offer("c")  # capacity freed
    assert q.pop() == "b" and q.pop() == "c" and q.pop() is None


# -- retry policy ------------------------------------------------------------


def test_backoff_deterministic_and_bounded():
    p1 = RetryPolicy(max_attempts=5, base_s=0.1, cap_s=1.0, seed=7)
    p2 = RetryPolicy(max_attempts=5, base_s=0.1, cap_s=1.0, seed=7)
    for rid in range(5):
        for attempt in range(1, 5):
            b = p1.backoff_s(rid, attempt)
            assert b == p2.backoff_s(rid, attempt)  # replayable
            raw = min(1.0, 0.1 * 2 ** (attempt - 1))
            assert raw / 2 <= b < raw  # jitter keeps [raw/2, raw)
    # Different seeds / rids de-synchronize.
    p3 = RetryPolicy(max_attempts=5, base_s=0.1, cap_s=1.0, seed=8)
    assert p3.backoff_s(0, 1) != p1.backoff_s(0, 1)
    assert p1.backoff_s(0, 1) != p1.backoff_s(1, 1)


def test_retry_policy_rejects_zero_attempts():
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)


# -- admission ---------------------------------------------------------------


def test_service_ema_zero_observation_decays_instead_of_reseeding():
    # Regression: the estimator's "unset" sentinel used to be == 0.0, so a
    # legitimate zero-duration observation (exactly what a virtual clock
    # produces for an instant dispatch) put the EMA back into the "never
    # observed" state and the NEXT sample hard-reset it instead of
    # decaying — one slow step after a fast one re-seeded the estimate to
    # the full slow value.  Unset is now None; 0.0 is data.
    srv = StudyServer(ServeConfig(device=CPU), clock=VirtualClock())
    assert srv._service_ema is None       # never observed
    srv._observe_service(10.0)
    assert srv._service_ema == 10.0       # first sample seeds
    srv._observe_service(0.0)
    assert srv._service_ema == pytest.approx(8.0)   # 0.8*10 + 0.2*0
    srv2 = StudyServer(ServeConfig(device=CPU), clock=VirtualClock())
    srv2._observe_service(0.0)
    assert srv2._service_ema == 0.0       # a real observation, not "unset"
    srv2._observe_service(10.0)
    assert srv2._service_ema == pytest.approx(2.0)  # decays, no hard reset


def test_malformed_spec_rejected_with_naming_error():
    srv = _server()
    resp = srv.submit({"workloads": ["not-a-real-app"]})
    assert resp.status == REJECTED_MALFORMED
    assert "not-a-real-app" in resp.error


def test_oversized_request_rejected_by_lane_bound():
    srv = _server(max_lanes=4)
    big = dict(SPEC, hw_grid={"offchip_bw_gbs": [float(b) for b in
                                                 range(16, 26)]})
    resp = srv.submit(big)
    assert resp.status == REJECTED_OVERSIZED
    assert "10 lanes" in resp.error


def test_overload_sheds_and_rids_stay_sequential():
    srv = _server(max_queue=2)
    outcomes = [srv.submit(SPEC) for _ in range(4)]
    assert outcomes[0] == 0 and outcomes[1] == 1  # queued: rid returned
    assert outcomes[2].status == REJECTED_OVERLOAD
    assert outcomes[2].rid == 2  # rejected submissions consume rids too
    assert outcomes[3].rid == 3
    assert srv.queue.shed == 2


# -- serving, retries, degradation ------------------------------------------


def test_clean_request_served_by_batched_planner():
    srv = _server()
    rid = srv.submit(SPEC)
    resp = srv.drain()[0]
    assert resp.rid == rid and resp.status == OK
    assert resp.engine == "batch" and resp.attempts == 1
    _assert_rows_equal(resp.results, _reference())


def test_transient_failure_retries_to_success_with_backoff():
    clock = VirtualClock()
    monkey = ChaosMonkey(ChaosConfig(seed=0, fault_rate=1.0,
                                     classes=("engine_exception",),
                                     transient_fraction=1.0), clock=clock)
    srv = _server(clock=clock, chaos=monkey, backoff_base_s=0.25)
    srv.submit(SPEC)
    resp = srv.drain()[0]
    assert resp.status == OK and resp.attempts == 2
    assert srv.stats["retry_successes"] == 1
    assert clock.slept > 0  # the backoff actually waited
    assert resp.latency_s >= clock.slept


def test_persistent_failure_degrades_bit_exact():
    monkey = ChaosMonkey(ChaosConfig(seed=0, fault_rate=1.0,
                                     classes=("engine_exception",),
                                     transient_fraction=0.0))
    srv = _server(chaos=monkey, max_attempts=2)
    srv.submit(SPEC)
    resp = srv.drain()[0]
    assert resp.status == OK_DEGRADED and resp.engine == "sequential"
    assert resp.attempts == 2 and "degraded" in resp.error
    # A degraded answer is never a wrong answer: bit-exact with the
    # fault-free sequential reference.
    _assert_rows_equal(resp.results, _reference())


def test_deadline_exceeded_before_dispatch_times_out():
    clock = VirtualClock()
    srv = _server(clock=clock, default_deadline_s=5.0)
    srv.submit(SPEC)
    clock.advance(6.0)  # request goes stale while queued
    resp = srv.drain()[0]
    assert resp.status == TIMEOUT and "deadline" in resp.error


def test_hang_detected_by_heartbeat_and_worker_cordoned():
    clock = VirtualClock()
    monkey = ChaosMonkey(ChaosConfig(seed=0, fault_rate=1.0,
                                     classes=("hang",), hang_s=60.0),
                         clock=clock)
    srv = _server(clock=clock, chaos=monkey, default_deadline_s=30.0,
                  heartbeat_timeout_s=20.0)
    srv.submit(SPEC)
    resp = srv.drain()[0]
    assert resp.status == TIMEOUT and "hang" in resp.error
    assert srv.stats["hangs_detected"] == 1
    # remove_host ran: the hung worker no longer poisons later requests...
    assert srv.hb.dead_hosts(now=clock.now()) == []
    assert [p["action"] for p in srv.restart_plans] == ["remesh"]
    # ...so the very next request on the replacement worker serves fine.
    monkey.exempt.add(1)
    srv.submit(SPEC)
    assert srv.drain()[0].status == OK


# -- warm manifest + crash-safe restart --------------------------------------


def test_warm_manifest_roundtrip_idempotent(tmp_path):
    srv = _server(cache_dir=str(tmp_path))
    srv.submit(SPEC)
    assert srv.drain()[0].status == OK
    entries = srv.warm.load_manifest()
    assert len(entries) == 2  # one per mechanism, single geometry bucket
    assert {e["mechanism"] for e in entries} == {"cpu", "lazypim"}
    assert all(e["lanes"] == 1 for e in entries)
    # Re-serving the same study adds nothing (idempotent merge).
    srv.submit(SPEC)
    srv.drain()
    assert srv.warm.load_manifest() == entries


def test_crash_keeps_journal_and_restart_replays(tmp_path):
    cfg = dict(cache_dir=str(tmp_path), default_deadline_s=1e9, device=CPU)
    monkey = ChaosMonkey(ChaosConfig(seed=0, fault_rate=1.0,
                                     classes=("crash",)))
    srv = _server(chaos=monkey, **cfg)
    rid = srv.submit(SPEC)
    srv.submit(SPEC)  # still queued when the worker dies
    resp = srv.step()
    assert resp.status == "crashed" and srv.crashed
    assert srv.step() is None  # a crashed server serves nothing
    assert sorted(srv._journal) == [0, 1]  # both unresolved rids journaled

    srv2, replayed = restart_server(
        ServeConfig(**cfg),
        chaos=ChaosMonkey(ChaosConfig(seed=0, fault_rate=1.0,
                                      classes=("crash",))))
    assert [(r.rid, r.status, r.restarted) for r in replayed] == \
        [(0, OK, True), (1, OK, True)]
    _assert_rows_equal(replayed[0].results, _reference())
    assert srv2._journal == {}  # replay resolved and cleared the journal
    # New submissions never collide with journaled rids.
    assert srv2.submit(SPEC) == 2


def test_restart_answers_from_warm_manifest_with_zero_new_builds_or_binds(
        tmp_path, monkeypatch):
    """The port's form of the reference's zero-new-compiles restart: after
    a process death (the bound library and the loaded kernel modules gone;
    the build directory and the manifest on disk), the restarted server's
    warm replay binds the library and launches every kernel the repeat
    study launches; the repeat study then builds nothing, binds nothing,
    and answers bit-exactly."""
    want = _reference()
    lib = standin.install(monkeypatch, tmp_path / "build")

    def since(start):
        now = _build.build_counts()
        return {k: now[k] - start[k] for k in now}

    try:
        start = _build.build_counts()
        cfg = ServeConfig(cache_dir=str(tmp_path / "cache"), default_deadline_s=1e9,
                          device=CPU)
        srv = StudyServer(cfg, clock=VirtualClock())
        srv.submit(SPEC)
        assert srv.drain()[0].status == OK
        assert since(start) == {"builds": 1, "binds": 1}  # the cold process

        standin.process_death(lib)
        srv2, replayed = restart_server(cfg, clock=VirtualClock())
        assert replayed == []  # nothing was in flight
        assert srv2.stats["warmed_entries"] == 2
        warmed, loaded = _build.build_counts(), set(lib.loaded)
        assert since(start) == {"builds": 1, "binds": 2}  # rebound, not rebuilt

        srv2.submit(SPEC)
        resp = srv2.drain()[0]
        assert resp.status == OK and resp.engine == "batch"
        assert _build.build_counts() == warmed  # zero new builds, zero new binds
        assert lib.loaded == loaded  # no kernel first launched after the warm replay
        _assert_rows_equal(resp.results, want)
    finally:
        K._lib.cache_clear()


# -- held to repro -----------------------------------------------------------


def test_backoff_draws_equal_reference():
    for seed in (0, 1, 7, 2**31 + 5, 2**40 + 3):
        t = RetryPolicy(max_attempts=9, base_s=0.05, cap_s=2.0, seed=seed)
        r = RRetryPolicy(max_attempts=9, base_s=0.05, cap_s=2.0, seed=seed)
        for rid in (*range(0, 40, 3), 2**32 - 1, 2**33 + 7):
            for attempt in range(1, 9):
                assert t.backoff_s(rid, attempt) == r.backoff_s(rid, attempt), \
                    (seed, rid, attempt)


MULTI = {"workloads": [{"app": "pagerank", "graph": "arxiv", "scale": 0.4, **SMALL},
                       {"app": "htap128", "scale": 0.004, **SMALL}],
         "mechanisms": ["cpu", "cg", "lazypim"], "threads": 16,
         "hw_grid": {"offchip_bw_gbs": [16.0, 32.0]}}


@pytest.mark.parametrize("spec", [SPEC, MULTI], ids=["one-bucket", "two-workloads-grid"])
def test_served_answer_and_manifest_rows_equal_reference(tmp_path, spec):
    got = _server(cache_dir=str(tmp_path / "torch"))
    want = RStudyServer(RServeConfig(cache_dir=str(tmp_path / "jax"),
                                     default_deadline_s=1e9), clock=RVirtualClock())
    for srv in (got, want):
        srv.submit(spec)
    (a,), (b,) = got.drain(), want.drain()
    assert (a.status, a.engine, a.attempts) == (b.status, b.engine, b.attempts) == \
        (OK, "batch", 1)
    assert a.results.to_rows() == b.results.to_rows()
    rows = got.warm.load_manifest()
    assert rows and rows == want.warm.load_manifest()


# -- the port's interface ----------------------------------------------------


def test_server_runs_on_the_card_unless_told_cpu():
    """``ServeConfig.device``: ``None`` is the CUDA card, and without one the
    server refuses to start; ``device="cpu"`` builds every request's Study
    there.  A Study object built on another device is a malformed request."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StudyServer(ServeConfig())
    srv = _server()
    assert srv.device == torch.device(CPU)
    srv.submit(SPEC)
    (resp,) = srv.drain()
    assert resp.status == OK
    assert all(tt.device == torch.device(CPU) for tt in build_study(SPEC, CPU).traces())
    assert build_study(build_study(SPEC, CPU), CPU).device == torch.device(CPU)
    if torch.cuda.is_available():
        resp = srv.submit(Study(workloads=["htap128"], device="cuda"))
        assert resp.status == REJECTED_MALFORMED and "built on" in resp.error


def test_lane_mesh_wider_than_one_device_raises_naming_a9(monkeypatch):
    """A lane mesh wider than the visible devices is refused at boot,
    naming the count (the CPU shows one device unless the mesh variable
    forces more)."""
    monkeypatch.delenv(MESH_ENV_VAR, raising=False)
    with pytest.raises(ValueError, match="devices=2 but only 1 visible"):
        _server(devices=2)


def test_persistent_cache_reports_the_build_directory(tmp_path, monkeypatch):
    """``enable_persistent_cache`` creates the cache directory and reports
    whether the (unmoved) build directory holds the current build of every
    csrc source."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert enable_persistent_cache(tmp_path / "cache") is False
    assert (tmp_path / "cache").is_dir() and _build.BUILD_DIR == tmp_path / "build"
    (tmp_path / "build").mkdir()
    sources = sorted(_build.CSRC.glob("*.cu"))
    for src in sources[:-1]:
        _build.library_path(src).touch()
    assert enable_persistent_cache(tmp_path / "cache") is False
    _build.library_path(sources[-1]).touch()
    assert enable_persistent_cache(tmp_path / "cache") is True
    assert WarmCache(tmp_path / "c2", device=CPU).persistent is True


def test_warm_skips_rows_from_a_wider_mesh(tmp_path):
    srv = _server(cache_dir=str(tmp_path))
    srv.submit(SPEC)
    assert srv.drain()[0].status == OK
    rows = srv.warm.load_manifest()
    (tmp_path / "warm_manifest.json").write_text(json.dumps(
        {"schema_version": 1, "entries": rows + [{**rows[0], "devices": 2}]}))
    srv2, _ = restart_server(srv.cfg, clock=VirtualClock())
    assert srv2.stats["warmed_entries"] == len(rows)
    assert srv2.warm.skipped_entries == 1
