"""The port's fault-isolated cross-request lane coalescing on the CPU,
mirroring ``tests/test_coalesce.py``: bit-exactness vs the one-at-a-time
loop, masked pad lanes, bisection isolation of poison requests (chaos
storms over >= 3 seeds), per-lane integrity sentinels, audit-mismatch
degradation, the blessed widths' warm rows and — in the port's terms — a
restarted server answering the same coalesced shape with zero ``nvcc``
builds and zero new library binds (``tests/_bloom_standin.py``), and the
hardening satellites (deadline-at-admission shed, manifest/journal
quarantine-and-rebuild, ResultSet schema errors).  Set
``REPRO_CHAOS_SEED`` to pin a single seed.

Held to ``repro`` itself: ``audit_sample`` bit for bit over a grid of
(seed, tag, lanes, fraction); a coalesced queue's answers and the warm rows
its groups write; each rid of the poison storms for seeds 0, 1 and 2
(status, engine, quarantine) and its ``to_rows()``, exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

import _bloom_standin as standin
from repro.serve import ChaosConfig as RChaosConfig
from repro.serve import ChaosMonkey as RChaosMonkey
from repro.serve import ServeConfig as RServeConfig
from repro.serve import StudyServer as RStudyServer
from repro.serve import VirtualClock as RVirtualClock
from repro.serve import audit_sample as r_audit_sample
from repro_torch.kernels import _build
from repro_torch.kernels.bloom import bloom as K
from repro_torch.serve import (
    BLESSED_LANE_WIDTHS,
    OK,
    OK_DEGRADED,
    QUARANTINED,
    SERVED,
    BoundedQueue,
    ChaosConfig,
    ChaosMonkey,
    InjectedEngineError,
    ServeConfig,
    StudyServer,
    VirtualClock,
    audit_sample,
    blessed_width,
    build_study,
    group_key,
    restart_server,
)
from repro_torch.sim.study import ResultSet, ResultSetSchemaError

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


# -- pure mechanics ----------------------------------------------------------


def test_blessed_width_rounds_up_to_pow2():
    assert [blessed_width(n) for n in (1, 2, 3, 4, 5, 8, 9, 64)] == \
        [1, 2, 4, 4, 8, 8, 16, 64]
    with pytest.raises(ValueError):
        blessed_width(0)
    with pytest.raises(ValueError):
        blessed_width(BLESSED_LANE_WIDTHS[-1] + 1)


def test_audit_sample_is_deterministic_and_bounded():
    s1 = audit_sample(0, 7, 16, 0.25)
    s2 = audit_sample(0, 7, 16, 0.25)
    assert s1 == s2 and len(s1) == 4
    assert all(0 <= i < 16 for i in s1) and sorted(set(s1)) == s1
    assert audit_sample(0, 8, 16, 0.25) != s1  # per-dispatch stream
    assert audit_sample(0, 7, 16, 0.0) == []
    assert audit_sample(0, 7, 5, 1.0) == [0, 1, 2, 3, 4]
    assert len(audit_sample(0, 7, 16, 0.01)) == 1  # at least one lane


def test_queue_take_removes_matches_preserving_order():
    q = BoundedQueue(8)
    for x in (1, 2, 3, 4, 5):
        q.offer(x)
    assert q.take(lambda x: x % 2 == 0) == [2, 4]
    assert [q.pop(), q.pop(), q.pop()] == [1, 3, 5]
    assert q.pop() is None


def test_group_key_compatibility():
    ka = group_key(build_study(SPEC_A, CPU))
    ka2 = group_key(build_study(SPEC_A2, CPU))
    kb = group_key(build_study(SPEC_B, CPU))
    assert ka is not None and ka == ka2  # hw axis is per-lane data
    assert ka != kb                      # different geometry bucket
    multi = build_study({**SPEC_A, "workloads": [
        SPEC_A["workloads"][0],
        {"app": "pagerank", "graph": "arxiv", "scale": 0.4,
         "num_kernels": 3, "windows_per_kernel": 40}]}, CPU)
    if len(multi.bucket_lanes()) > 1:  # windows differ but bucket may merge
        assert group_key(multi) is None


# -- bit-exactness and pad-lane masking --------------------------------------


def test_coalesced_bit_exact_vs_one_at_a_time():
    specs = [SPEC_A, SPEC_B, SPEC_A2, SPEC_A, SPEC_B, SPEC_A, SPEC_A2,
             SPEC_B]  # queue depth 8, three group keys
    co = _server(audit_fraction=1.0)
    for s in specs:
        co.submit(s)
    coalesced = co.drain()

    solo = StudyServer(ServeConfig(default_deadline_s=1e9, device=CPU),
                       clock=VirtualClock())
    for s in specs:
        solo.submit(s)
    baseline = solo.drain()

    assert len(coalesced) == len(baseline) == len(specs)
    assert co.stats["coalesced_dispatches"] >= 1
    # Coalesced drain resolves in group order (the head pulls compatible
    # peers forward), so align by rid — every request must still resolve.
    by_rid = {r.rid: r for r in coalesced}
    assert sorted(by_rid) == sorted(b.rid for b in baseline)
    for b in baseline:
        a = by_rid[b.rid]
        assert a.status == OK and a.engine == "coalesced"
        assert b.status == OK and b.engine == "batch"
        _assert_rows_equal(a.results, b.results)


def test_masked_pad_lanes_never_contribute():
    # Three lanes pad to blessed width 4: one all-sentinel masked lane
    # rides the dispatch.  Every served number must equal the unpadded
    # study run AND the sequential reference, field-exact.
    srv = _server(audit_fraction=0.0)
    for _ in range(3):
        srv.submit(SPEC_A)
    out = srv.drain()
    assert [r.status for r in out] == [OK] * 3
    assert srv.stats["coalesced_dispatches"] == 1
    ref = _seq(SPEC_A)
    for r in out:
        _assert_rows_equal(r.results, ref)


def test_multi_bucket_request_falls_back_to_single_request_path():
    spec = {**SPEC_A, "workloads": [
        {"app": "pagerank", "graph": "arxiv", "scale": 0.4, **SMALL},
        {"app": "pagerank", "graph": "arxiv", "scale": 3.0,
         "num_kernels": 3, "windows_per_kernel": 2}]}
    study = build_study(spec, CPU)
    if group_key(study) is not None:
        pytest.skip("scales landed in one geometry bucket")
    srv = _server()
    srv.submit(spec)
    (resp,) = srv.drain()
    assert resp.status == OK and resp.engine == "batch"
    _assert_rows_equal(resp.results, _seq(spec))


# -- poison isolation (the robustness headline) ------------------------------


def _poison_storm(seed, classes, n=8, fault_rate=0.25, audit=1.0):
    clock = VirtualClock()
    monkey = ChaosMonkey(ChaosConfig(seed=seed, fault_rate=fault_rate,
                                     classes=classes), clock=clock)
    srv = _server(clock=clock, chaos=monkey, audit_fraction=audit,
                  seed=seed)
    for _ in range(n):
        srv.submit(SPEC_A)
    out = srv.drain()
    faults = {rid: monkey.fault_for(rid) for rid in range(n)}
    return srv, out, faults


@pytest.mark.parametrize("seed", SEEDS)
def test_poison_lane_bisection_isolates_exactly_the_poison(seed):
    srv, out, faults = _poison_storm(seed, ("poison_lane",))
    poisoned = {rid for rid, f in faults.items() if f == "poison_lane"}
    assert poisoned, f"seed {seed} drew no poison_lane faults; pick another"
    ref = _seq(SPEC_A)
    for r in out:
        if r.rid in poisoned:
            # The offender is quarantined with its bisection trace...
            assert r.status == QUARANTINED
            assert "bisection" in r.error
            rec = srv.quarantine[r.rid]
            assert rec["spec"] == SPEC_A
            assert any("failed" in ev["outcome"]
                       for ev in rec["bisection"])
            # ...and every failed sub-dispatch in its trace contained it.
            for ev in rec["bisection"]:
                if "failed" in ev["outcome"]:
                    assert set(ev["members"]) & poisoned
        else:
            # Healthy co-batched neighbors are never timed out, degraded
            # away, or corrupted: served ok, bit-exact.
            assert r.status == OK, (r.rid, r.status, r.error)
            _assert_rows_equal(r.results, ref)
    assert set(srv.quarantine) == poisoned


@pytest.mark.parametrize("seed", SEEDS)
def test_poison_result_storm_never_serves_a_wrong_answer(seed):
    srv, out, faults = _poison_storm(seed, ("poison_result",),
                                     fault_rate=0.3)
    poisoned = {rid for rid, f in faults.items() if f == "poison_result"}
    assert poisoned, f"seed {seed} drew no poison_result faults"
    injected = dict(srv.chaos.injected)
    ref = _seq(SPEC_A)
    for r in out:
        kind = injected.get(r.rid)
        if kind == "poison_result:nan":
            # NaN trips the finalize sentinel: lane-exact attribution,
            # no bisection needed, straight to quarantine.
            assert r.status == QUARANTINED
            assert "integrity sentinel" in r.error
            assert r.rid in srv.quarantine
        else:
            # Finite corruption anywhere in the batch is caught by the
            # audit, which degrades the whole sub-batch to the sequential
            # reference — so even the poisoned request's answer is
            # *correct* (recomputed), and healthy members always are.
            assert r.status in SERVED, (r.rid, r.status, r.error)
            _assert_rows_equal(r.results, ref)
    if any(k == "poison_result:finite" for k in injected.values()):
        assert srv.stats["audit_mismatches"] >= 1
        assert any(r.status == OK_DEGRADED for r in out)


def test_poison_result_nan_is_lane_attributed():
    # Seed 2 deterministically draws the NaN variant for rid 2 (and only
    # rid 2) at fault_rate 0.3 — neighbors stay ok on the same dispatch.
    srv, out, faults = _poison_storm(2, ("poison_result",), n=6,
                                     fault_rate=0.3)
    statuses = {r.rid: r.status for r in out}
    assert statuses[2] == QUARANTINED
    assert all(s == OK for rid, s in statuses.items() if rid != 2)
    assert list(srv.quarantine) == [2]


class _SlowFaultMonkey(ChaosMonkey):
    """poison_lane faults that burn virtual wall before dying — the cost a
    real clock sees when a poisoned engine execution fails partway in,
    multiplied across every bisection sub-dispatch containing the poison."""

    def __init__(self, cfg, clock, fault_wall_s):
        super().__init__(cfg, clock=clock)
        self.fault_wall_s = fault_wall_s

    def on_coalesced_dispatch(self, rids, dispatch):
        try:
            super().on_coalesced_dispatch(rids, dispatch)
        except InjectedEngineError:
            self.clock.advance(self.fault_wall_s)
            raise


@pytest.mark.parametrize("seed", SEEDS)
def test_healthy_request_admitted_after_poison_storm(seed):
    # Regression: the admission estimator's service-time EMA must not be
    # poisoned by quarantine/bisection incidents.  The pre-fix step() gate
    # excluded only TIMEOUT/CRASHED, so a quarantine-bearing step fed its
    # fault-handling wall (here 900 s per failed bisection sub-dispatch)
    # into the EMA — inflating it past any default deadline and shedding
    # every later healthy request as overload, permanently: a shed request
    # never runs, so nothing ever corrects the estimate back down.
    clock = VirtualClock()
    monkey = _SlowFaultMonkey(
        ChaosConfig(seed=seed, fault_rate=0.25, classes=("poison_lane",)),
        clock, fault_wall_s=900.0)
    srv = StudyServer(ServeConfig(coalesce=True, audit_fraction=1.0,
                                  seed=seed, device=CPU),
                      clock=clock, chaos=monkey)
    for _ in range(8):
        srv.submit(SPEC_A, deadline_s=1e9)
    out = srv.drain()
    assert any(r.status == QUARANTINED for r in out)  # a real storm
    # A healthy follow-up at the DEFAULT deadline (300 s << the storm's
    # accumulated bisection wall) must be admitted and served.
    monkey.exempt.add(8)
    rid = srv.submit(SPEC_A)
    assert isinstance(rid, int), f"healthy follow-up shed: {rid}"
    (resp,) = srv.drain()
    assert resp.status == OK
    # ...and the now-observed healthy service time keeps admitting.
    monkey.exempt.add(9)
    rid2 = srv.submit(SPEC_A)
    assert isinstance(rid2, int), f"second follow-up shed: {rid2}"
    (resp2,) = srv.drain()
    assert resp2.status == OK


# -- blessed widths: warm manifest + compile-key reuse -----------------------


def test_blessed_width_warm_entries_and_zero_new_builds_or_binds(tmp_path,
                                                                monkeypatch):
    """The port's form of the reference's blessed-width compile-key reuse:
    the coalesced group's warm rows carry its blessed width, and after a
    process death the restarted server's warm replay leaves the same
    coalesced shape nothing to build, bind or first-launch."""
    want = _seq(SPEC_A)
    lib = standin.install(monkeypatch, tmp_path / "build")
    try:
        cfg = ServeConfig(cache_dir=str(tmp_path / "cache"), default_deadline_s=1e9,
                          coalesce=True, audit_fraction=0.0, device=CPU)
        srv = StudyServer(cfg, clock=VirtualClock())
        for _ in range(3):  # 3 lanes -> blessed width 4
            srv.submit(SPEC_A)
        assert all(r.status == OK for r in srv.drain())
        entries = srv.warm.load_manifest()
        assert {e["lanes"] for e in entries} == {4}
        assert all(e["lanes"] in BLESSED_LANE_WIDTHS for e in entries)

        standin.process_death(lib)
        srv2, replayed = restart_server(cfg, clock=VirtualClock())
        assert replayed == []
        warmed, loaded = _build.build_counts(), set(lib.loaded)
        for _ in range(3):
            srv2.submit(SPEC_A)
        out = srv2.drain()
        assert all(r.status == OK and r.engine == "coalesced" for r in out)
        assert _build.build_counts() == warmed  # the blessed widths were re-warmed
        assert lib.loaded == loaded
        for r in out:
            _assert_rows_equal(r.results, want)
    finally:
        K._lib.cache_clear()


# -- deadline accounting at admission ----------------------------------------


def test_request_that_would_expire_while_queued_sheds_at_admission():
    srv = _server(coalesce=False)
    srv._service_ema = 10.0  # measured: ~10 s of service per request
    assert isinstance(srv.submit(SPEC_A, deadline_s=1e9), int)
    # Two requests ahead -> ~30 s to completion; a 5 s deadline cannot be
    # met, so the request sheds now instead of timing out after dispatch.
    resp = srv.submit(SPEC_A, deadline_s=5.0)
    assert resp.status == "rejected_overload"
    assert "would expire while queued" in resp.error
    # A deadline the queue can meet is admitted.
    assert isinstance(srv.submit(SPEC_A, deadline_s=60.0), int)


# -- persistence hardening (schema versions + quarantine-and-rebuild) --------


def test_corrupt_warm_manifest_quarantined_not_wedging_restart(tmp_path):
    cfg = ServeConfig(cache_dir=str(tmp_path), default_deadline_s=1e9, device=CPU)
    srv = StudyServer(cfg, clock=VirtualClock())
    srv.submit(SPEC_A)
    assert srv.drain()[0].status == OK
    manifest = srv.warm.manifest_path
    manifest.write_text(manifest.read_text()[:40])  # torn write

    srv2, replayed = restart_server(cfg, clock=VirtualClock())
    assert replayed == []
    assert srv2.warm.quarantined_manifests == 1
    assert (tmp_path / "warm_manifest.json.corrupt-0").exists()
    assert not manifest.exists()  # rebuilt from empty on next record
    assert srv2.submit(SPEC_A) == 0 or True
    assert srv2.drain()[0].status == OK
    assert len(srv2.warm.load_manifest()) == 2  # rebuilt


def test_wrong_manifest_schema_version_quarantined(tmp_path):
    cfg = ServeConfig(cache_dir=str(tmp_path), default_deadline_s=1e9, device=CPU)
    srv = StudyServer(cfg, clock=VirtualClock())
    srv.warm.manifest_path.write_text(json.dumps(
        {"schema_version": 999, "entries": []}))
    assert srv.warm.load_manifest() == []
    assert srv.warm.quarantined_manifests == 1


def test_corrupt_journal_quarantined_not_wedging_restart(tmp_path):
    cfg = ServeConfig(cache_dir=str(tmp_path), default_deadline_s=1e9, device=CPU)
    (tmp_path / "journal.json").write_text('{"next_rid": 3, "inflight"')
    srv, replayed = restart_server(cfg, clock=VirtualClock())
    assert replayed == []
    assert srv.stats["quarantined_journals"] == 1
    assert (tmp_path / "journal.json.corrupt-0").exists()
    assert isinstance(srv.submit(SPEC_A), int)
    assert srv.drain()[0].status == OK


def test_resultset_load_json_raises_named_schema_errors(tmp_path):
    rs = _seq(SPEC_A)
    path = rs.save_json(tmp_path / "rs.json")
    loaded = ResultSet.load_json(path)
    _assert_rows_equal(loaded, rs)

    torn = tmp_path / "torn.json"
    torn.write_text(path.read_text()[:25])
    with pytest.raises(ResultSetSchemaError, match="truncated or corrupt"):
        ResultSet.load_json(torn)

    payload = json.loads(path.read_text())
    payload["schema_version"] = 999
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(payload))
    with pytest.raises(ResultSetSchemaError, match="schema_version"):
        ResultSet.load_json(bad)

    # Pre-stamp goldens (no version field) are version 1: must load.
    payload = json.loads(path.read_text())
    del payload["schema_version"]
    legacy = tmp_path / "legacy.json"
    legacy.write_text(json.dumps(payload))
    _assert_rows_equal(ResultSet.load_json(legacy), rs)

    mangled = tmp_path / "mangled.json"
    payload = json.loads(path.read_text())
    del payload["points"][0]["results"]
    mangled.write_text(json.dumps(payload))
    with pytest.raises(ResultSetSchemaError, match="malformed"):
        ResultSet.load_json(mangled)


# -- held to repro -----------------------------------------------------------


def test_audit_sample_equals_reference():
    for seed in (0, 1, 7, 2**32 + 1):
        for tag in (0, 1, 5, 2**31 + 7):
            for lanes in (0, 1, 2, 3, 5, 8, 17, 64):
                for fraction in (0.0, 0.01, 0.25, 0.5, 1.0):
                    assert audit_sample(seed, tag, lanes, fraction) == \
                        r_audit_sample(seed, tag, lanes, fraction), \
                        (seed, tag, lanes, fraction)


def _rserver(**cfg_kw):
    return RStudyServer(RServeConfig(default_deadline_s=1e9, coalesce=True, **cfg_kw),
                        clock=RVirtualClock())


def test_coalesced_answers_and_warm_rows_equal_reference(tmp_path):
    specs = [SPEC_A, SPEC_B, SPEC_A2, SPEC_A, SPEC_B]
    got = _server(audit_fraction=1.0, cache_dir=str(tmp_path / "torch"))
    want = _rserver(audit_fraction=1.0, cache_dir=str(tmp_path / "jax"))
    for srv in (got, want):
        for s in specs:
            srv.submit(s)
    a = {r.rid: r for r in got.drain()}
    b = {r.rid: r for r in want.drain()}
    assert sorted(a) == sorted(b) == list(range(len(specs)))
    for rid in b:
        assert (a[rid].status, a[rid].engine) == (b[rid].status, b[rid].engine) == \
            (OK, "coalesced")
        assert a[rid].results.to_rows() == b[rid].results.to_rows()
    assert got.telemetry.dispatch_widths == want.telemetry.dispatch_widths
    assert got.stats == want.stats
    assert got.warm.load_manifest() == want.warm.load_manifest()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_poison_storm_outcomes_equal_reference(seed):
    classes = ("poison_lane", "poison_result")
    srv, out, _ = _poison_storm(seed, classes, fault_rate=0.3)
    clock = RVirtualClock()
    monkey = RChaosMonkey(RChaosConfig(seed=seed, fault_rate=0.3, classes=classes),
                          clock=clock)
    ref = RStudyServer(RServeConfig(default_deadline_s=1e9, coalesce=True,
                                    audit_fraction=1.0, seed=seed),
                       clock=clock, chaos=monkey)
    for _ in range(8):
        ref.submit(SPEC_A)
    want = {r.rid: r for r in ref.drain()}
    got = {r.rid: r for r in out}
    assert sorted(got) == sorted(want)
    for rid, b in want.items():
        a = got[rid]
        assert (a.status, a.engine, a.attempts) == (b.status, b.engine, b.attempts), rid
        if b.results is not None:
            assert a.results.to_rows() == b.results.to_rows(), rid
    assert srv.chaos.injected == monkey.injected
    assert {rid: [ev["outcome"].split(":")[0] for ev in q["bisection"]]
            for rid, q in srv.quarantine.items()} == \
        {rid: [ev["outcome"].split(":")[0] for ev in q["bisection"]]
         for rid, q in ref.quarantine.items()}
