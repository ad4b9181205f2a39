"""The port's lane mesh (repro_torch.sim.mesh and its callers): the routing
and padding policy held to repro's, the sharded planner held bit for bit to
the port's own single-device run (every mechanism x bucket x
partial/full commit, lane counts not a mesh multiple), the dispatch
boundary, the warm manifest's device dimension, ``ServeConfig.devices``
and a coalesced storm on a two-device mesh; and the kernel wrappers
launching with their tensors' device current.  The mirror of
``tests/test_mesh_dispatch.py``.

The multi-device legs run on a CPU mesh: ``XLA_FORCE_HOST_PLATFORM_
DEVICE_COUNT`` (``MESH_ENV_VAR``) gives the port's CPU that many mesh
entries, read at call time, so each test sets it with ``monkeypatch``.
The reference's sharded runs are no oracle here: under JAX 0.9.0 with
forced host devices ``shard_map``'s varying-axes check rejects the window
scan's carries (``repro/core/mechanisms.py:239``), so its own sharded legs
fail there.  Its pure routing helpers, ``study_warm_entries`` (which
queries no device) and ``Study.plan(devices=4)`` (in a subprocess with the
variable set) are the oracles, and the port's ``devices=1`` run — held to
repro's single-device results by the other test files — is the reference
of the sharded one."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _bloom_standin as standin
from repro.core.coherence import LazyPIMConfig as RLazyPIMConfig
from repro.serve import blessed_width as r_blessed_width
from repro.serve.warm import study_warm_entries as r_study_warm_entries
from repro.sim import mesh as r_mesh
from repro.sim.study import Study as RStudy
from repro.sim.study import grid as r_grid
from repro.sim.study import workload as r_workload
from repro_torch.core.coherence import LazyPIMConfig
from repro_torch.kernels import _build
from repro_torch.kernels.bloom import bloom as K
from repro_torch.serve import (
    BLESSED_LANE_WIDTHS,
    OK,
    QUARANTINED,
    ChaosConfig,
    ChaosMonkey,
    ServeConfig,
    StudyServer,
    VirtualClock,
    blessed_width,
)
from repro_torch.serve.warm import WarmCache, study_warm_entries
from repro_torch.sim import engine as _engine
from repro_torch.sim import mesh
from repro_torch.sim.study import Study, grid, workload

CPU = "cpu"
MESH = 4  # the CPU mesh the multi-device tests force
SMALL = dict(scale=0.4, num_kernels=3, windows_per_kernel=2)
SPEC_A = {
    "workloads": [{"app": "pagerank", "graph": "arxiv", **SMALL}],
    "mechanisms": ["cpu", "lazypim"],
    "threads": 16,
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cpu_mesh(monkeypatch):
    """A CPU mesh of ``MESH`` devices for this test."""
    monkeypatch.setenv(mesh.MESH_ENV_VAR, str(MESH))
    return MESH


def _study(partial_commits=True, hw_points=3, mod=None):
    """Two geometry buckets x ``hw_points`` lanes each, every mechanism —
    lane counts deliberately not multiples of the mesh size."""
    if mod == "repro":
        st, gr, wl, lz, kw = RStudy, r_grid, r_workload, RLazyPIMConfig, {}
    else:
        st, gr, wl, lz, kw = Study, grid, workload, LazyPIMConfig, {"device": CPU}
    return st(workloads=[wl("pagerank", "arxiv", **SMALL),
                         wl("htap128", scale=0.004, num_kernels=3, windows_per_kernel=2)],
              hw=gr(offchip_bw_gbs=[float(16 * 2 ** i) for i in range(hw_points)]),
              mechanisms=_engine.MECHANISMS,
              lazy=lz(partial_commits=partial_commits), **kw)


def _small(hw_points: int, mechanisms=_engine.MECHANISMS) -> Study:
    return Study(workloads=[workload("pagerank", "arxiv", **SMALL)],
                 hw=grid(offchip_bw_gbs=[float(16 + 8 * i) for i in range(hw_points)]),
                 mechanisms=mechanisms, device=CPU)


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


# -- routing / padding policy -------------------------------------------------


def test_routing_helpers_match_reference():
    assert mesh.MESH_ENV_VAR == r_mesh.MESH_ENV_VAR
    assert mesh.LANE_AXIS == r_mesh.LANE_AXIS == "lanes"
    for lanes in range(1, 70):
        for d in range(1, 9):
            assert mesh.devices_for(lanes, d) == r_mesh.devices_for(lanes, d), (lanes, d)
            assert mesh.mesh_lane_width(lanes, d) == r_mesh.mesh_lane_width(lanes, d)
    assert [mesh.devices_for(n, 4) for n in (1, 2, 3, 4, 5, 8)] == [1, 2, 2, 4, 4, 4]
    assert [mesh.mesh_lane_width(n, 4) for n in (1, 3, 4, 5, 8)] == [4, 4, 4, 8, 8]
    for fn, args in ((mesh.devices_for, (0, 4)), (mesh.mesh_lane_width, (5, 0))):
        with pytest.raises(ValueError):
            fn(*args)


def test_resolve_devices_bounds(cpu_mesh, monkeypatch):
    assert mesh.available_devices(CPU) == MESH
    assert mesh.resolve_devices(None, CPU) == MESH
    assert mesh.resolve_devices(1, CPU) == 1
    assert mesh.lane_mesh(2, CPU) == (torch.device(CPU),) * 2
    with pytest.raises(ValueError, match="devices must be >= 1"):
        mesh.resolve_devices(0, CPU)
    with pytest.raises(ValueError, match=f"devices={MESH + 1} but only {MESH} visible"
                                         f".*{mesh.MESH_ENV_VAR}"):
        mesh.resolve_devices(MESH + 1, CPU)
    monkeypatch.setenv(mesh.MESH_ENV_VAR, "2")  # read at call time, not at import
    assert mesh.resolve_devices(None, CPU) == 2
    monkeypatch.delenv(mesh.MESH_ENV_VAR)
    assert mesh.resolve_devices(None, CPU) == 1
    with pytest.raises(ValueError, match="only 1 visible"):
        mesh.resolve_devices(2, CPU)


def test_blessed_widths_compose_with_mesh_sizes():
    assert blessed_width(3, 2) == 4
    assert blessed_width(1, 2) == 2
    assert blessed_width(5, 4) == 8
    assert blessed_width(3) == blessed_width(3, 1) == 4
    for d in (1, 2, 4, 8):
        for n in range(1, BLESSED_LANE_WIDTHS[-1] + 1):
            w = blessed_width(n, d)
            assert w == r_blessed_width(n, d)
            assert w in BLESSED_LANE_WIDTHS and w >= n and w % d == 0
    with pytest.raises(ValueError):
        blessed_width(0, 2)
    with pytest.raises(ValueError):
        blessed_width(BLESSED_LANE_WIDTHS[-1], BLESSED_LANE_WIDTHS[-1] * 2)


def test_shard_lanes_splits_runs_and_gathers_in_lane_order(cpu_mesh):
    seen = []

    def fn(stt, shw, scfg):
        seen.append((stt.window_valid.shape[0], shw.freq_ghz.device))
        return {"lane": shw.freq_ghz, "w": stt.window_valid.sum(1)}

    bl = _small(5).bucket_lanes()[0]
    stt = _engine.stack_traces(bl.traces + bl.traces[:3])
    hws = [dataclasses.replace(h, freq_ghz=float(i))
           for i, h in enumerate(bl.hws + bl.hws[:3])]
    shw = _engine.stack_hw(hws, CPU)
    scfg = _engine.stack_lazy(bl.lazys + bl.lazys[:3], CPU)
    out = mesh.shard_lanes(fn, 4, CPU)(stt, shw, scfg)
    assert seen == [(2, torch.device(CPU))] * 4
    assert out["lane"].tolist() == [float(i) for i in range(8)]
    with pytest.raises(ValueError, match="do not shard"):
        mesh.shard_lanes(fn, 3, CPU)(stt, shw, scfg)


def test_single_device_path_makes_no_shard_call(cpu_mesh, monkeypatch):
    """``devices=1`` runs the single-device dispatch itself: no shard call,
    no split, no copy; the same results as before the mesh."""
    want = _small(3).run(devices=1)

    def no_shard(*a, **kw):
        raise AssertionError("devices=1 made a shard call")

    monkeypatch.setattr(mesh, "shard_lanes", no_shard)
    monkeypatch.setattr(mesh, "_shard", no_shard)
    _assert_rows_equal(_small(3).run(devices=1), want)
    monkeypatch.delenv(mesh.MESH_ENV_VAR)
    _assert_rows_equal(_small(3).run(), want)  # None: the CPU's one device


def test_sequential_engine_rejects_multi_device(cpu_mesh):
    st = _small(1, ("cpu",))
    with pytest.raises(ValueError, match="sequential"):
        st.run(engine="sequential", devices=2)


def test_plan_predicts_device_routing_and_padding(cpu_mesh):
    plan = _study().plan(devices=1)
    assert plan.devices == 1
    assert all(b["devices"] == 1 and b["padded_lanes"] == b["lanes"] for b in plan.buckets)
    plan = _study(hw_points=5).plan()  # None = every visible device
    assert plan.devices == MESH
    for b in plan.buckets:
        assert b["devices"] == mesh.devices_for(b["lanes"], MESH) == MESH
        assert b["padded_lanes"] == 8 and b["lanes"] == 5
    assert "lane mesh over 4 devices" in plan.describe()
    assert plan.dispatches == _study(hw_points=5).plan(devices=1).dispatches


def test_plan_matches_reference_on_forced_devices(cpu_mesh):
    """repro's ``Study.plan(devices=4)`` needs forced XLA host devices, so it
    runs in a fresh process with the variable set before JAX starts."""
    code = (
        "import json, sys\n"
        "sys.path.insert(0, 'tests')\n"
        "from repro.sim import mesh\n"
        "from test_torch_mesh_dispatch import _study\n"
        "out = {}\n"
        "for n in (3, 5):\n"
        "    p = _study(hw_points=n, mod='repro').plan(devices=4)\n"
        "    out[n] = [p.devices, [dict(b) for b in p.buckets]]\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, **{mesh.MESH_ENV_VAR: str(MESH), "JAX_PLATFORMS": "cpu"})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(root, "src"), root,
                                         env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    for n in (3, 5):
        plan = _study(hw_points=n).plan(devices=4)
        got = [plan.devices, [dict(b) for b in plan.buckets]]
        assert json.loads(json.dumps(got)) == want[str(n)], n


# -- differential: sharded vs single-device, bit-exact -----------------------


@pytest.mark.parametrize("devices,hw_points", [(2, 3), (4, 5)])
@pytest.mark.parametrize("partial_commits", [True, False])
def test_sharded_study_bit_exact_with_single_device(cpu_mesh, partial_commits, devices,
                                                    hw_points):
    """3 lanes a bucket on 2 devices and 5 on 4: every dispatch pads (the
    planner's mesh padding), and every SimResult field of every mechanism,
    bucket and lane equals the single-device rows."""
    ref = _study(partial_commits, hw_points).run(devices=1)
    st = _study(partial_commits, hw_points)
    assert {b["devices"] for b in st.plan(devices=devices).buckets} == {devices}
    _assert_rows_equal(ref, st.run(devices=devices))


def test_mesh_pad_lanes_never_contribute(cpu_mesh):
    """5 lanes on 4 devices pads 3 all-sentinel lanes; a 1-lane study pads
    none.  Both equal their unsharded runs field for field."""
    for hw_points in (1, 5):
        _assert_rows_equal(_small(hw_points).run(devices=1), _small(hw_points).run())


def test_dispatch_devices_reported_to_boundary(cpu_mesh):
    seen = []

    def spy(info, thunk):
        seen.append((info.mechanism, info.lanes, info.devices))
        return thunk()

    st = _small(3, ("cpu",))
    st.run(on_dispatch=spy, devices=1)
    assert seen == [("cpu", 3, 1)]
    seen.clear()
    st.run(on_dispatch=spy)
    assert seen == [("cpu", 3, mesh.devices_for(3, MESH))]


# -- warm manifest: the device-count dimension --------------------------------


def test_warm_entries_record_mesh_routing_as_reference():
    st = _small(3, ("cpu", "lazypim"))
    for e in study_warm_entries(st):
        assert e["devices"] == 1 and e["lanes"] == 3
    r_st = RStudy(workloads=[r_workload("pagerank", "arxiv", **SMALL)],
                  hw=r_grid(offchip_bw_gbs=[16.0, 24.0, 32.0]),
                  mechanisms=("cpu", "lazypim"))
    for d in (1, 2, 4):
        got, want = study_warm_entries(st, devices=d), r_study_warm_entries(r_st, devices=d)
        assert got == want, d
    for e in study_warm_entries(st, devices=4):
        assert e["devices"] == 2 and e["lanes"] == 4


def test_warm_replay_skips_overwide_mesh_entries(tmp_path, cpu_mesh):
    """A manifest carried over from a bigger host: rows wider than this
    host's mesh are skipped and counted; the others replay at their
    recorded mesh size (a devices=2 row runs sharded)."""
    st = _small(2, ("cpu",))
    st.traces()
    entries = study_warm_entries(st, devices=2)
    assert entries[0]["devices"] == 2
    legacy = {k: v for k, v in entries[0].items() if k != "devices"}
    overwide = dict(entries[0], devices=64)
    wc = WarmCache(tmp_path, device=CPU)
    assert wc.record_entries(entries + [legacy, overwide]) == 3
    assert wc.warm_from_manifest() == 2  # the devices=2 row + the legacy row
    assert wc.skipped_entries == 1


def test_serve_config_devices_validated_at_boot(cpu_mesh, monkeypatch):
    with pytest.raises(ValueError, match=f"devices={MESH + 1} but only {MESH} visible"):
        StudyServer(ServeConfig(devices=MESH + 1, device=CPU), clock=VirtualClock())
    assert StudyServer(ServeConfig(device=CPU), clock=VirtualClock())._devices == MESH
    monkeypatch.delenv(mesh.MESH_ENV_VAR)
    with pytest.raises(ValueError, match="devices=2 but only 1 visible"):
        StudyServer(ServeConfig(devices=2, device=CPU), clock=VirtualClock())


# -- mesh-transparent serve ---------------------------------------------------


def _storm(seed, devices):
    clock = VirtualClock()
    monkey = ChaosMonkey(ChaosConfig(seed=seed, fault_rate=0.25,
                                     classes=("poison_lane",)), clock=clock)
    srv = StudyServer(ServeConfig(default_deadline_s=1e9, coalesce=True,
                                  audit_fraction=1.0, seed=seed, devices=devices,
                                  device=CPU),
                      clock=clock, chaos=monkey)
    for _ in range(8):
        srv.submit(SPEC_A)
    return srv, srv.drain()


def test_coalesced_storm_is_mesh_transparent(cpu_mesh):
    """Bisection, quarantine and the sequential audit are lane-slice logic;
    sharding the dispatch over two devices changes no decision and no
    number (seed 0)."""
    ref_srv, ref_out = _storm(0, devices=1)
    mesh_srv, mesh_out = _storm(0, devices=2)
    assert [(r.rid, r.status) for r in ref_out] == [(r.rid, r.status) for r in mesh_out]
    assert set(ref_srv.quarantine) == set(mesh_srv.quarantine)
    assert ref_srv.stats["bisections"] == mesh_srv.stats["bisections"]
    assert ref_srv.stats["audit_lanes"] == mesh_srv.stats["audit_lanes"]
    assert ref_srv.stats["coalesced_dispatches"] == mesh_srv.stats["coalesced_dispatches"] > 0
    for a, b in zip(ref_out, mesh_out):
        if a.status == OK:
            _assert_rows_equal(a.results, b.results)
        else:
            assert a.status == QUARANTINED


def test_mesh_server_healthy_coalesced_group_bit_exact(tmp_path, cpu_mesh):
    """Healthy coalesced traffic on a two-device mesh server: the manifest
    rows carry the routed device count, and a single-device server serves
    the identical numbers."""
    def serve(devices, cache):
        srv = StudyServer(ServeConfig(default_deadline_s=1e9, coalesce=True,
                                      audit_fraction=0.0, devices=devices,
                                      cache_dir=cache, device=CPU),
                          clock=VirtualClock())
        for _ in range(3):  # 3 lanes -> blessed width 4, a mesh multiple
            srv.submit(SPEC_A)
        return srv, srv.drain()

    srv1, out1 = serve(1, str(tmp_path / "one"))
    srv2, out2 = serve(2, str(tmp_path / "two"))
    assert all(r.status == OK and r.engine == "coalesced" for r in out1 + out2)
    for a, b in zip(out1, out2):
        _assert_rows_equal(a.results, b.results)
    assert {e["devices"] for e in srv1.warm.load_manifest()} == {1}
    assert {e["devices"] for e in srv2.warm.load_manifest()} == {2}
    assert {e["lanes"] for e in srv2.warm.load_manifest()} == {4}


# -- kernel launches run with their tensors' device current -------------------


def test_kernel_launches_run_under_their_tensors_device(tmp_path, cpu_mesh, monkeypatch):
    """Every Bloom launch of a sharded LazyPIM study, through the stand-in
    library on the real ``_build`` code, runs inside ``_build.on_device``
    of the device of the tensors it launches on — on a card, each mesh
    shard's kernels on its own card — and the sharded results equal the
    plain path's."""
    want = _small(3, ("lazypim",)).run(devices=1)
    lib = standin.install(monkeypatch, tmp_path / "build")
    try:
        got = _small(3, ("lazypim",)).run(devices=2)
    finally:
        K._lib.cache_clear()
    _assert_rows_equal(got, want)
    names = {n for n, _ in lib.launched}
    assert {"h3_hash_launch", "bloom_insert_ids_launch", "bloom_query_launch",
            "bloom_intersect_pair_launch"} <= names
    assert {d for _, d in lib.launched} == {torch.device(CPU)}
    assert lib.current is None  # every guard was left


def test_on_device_is_the_cuda_context_of_a_cuda_device_only():
    assert isinstance(_build.on_device(None), contextlib.nullcontext)
    assert isinstance(_build.on_device(torch.device(CPU)), contextlib.nullcontext)
