"""The port's slice as a whole held against repro on the CPU: every
SimResult field of the six mechanisms on small graph and HTAP traces, with
partial and full commits; batch == sequential exactly in the port; the
Study plan, ResultSet JSON across packages, and the entry points' device
rule (CUDA by default, ``device="cpu"`` only when asked)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.api import LazyPIMConfig as RLazy
from repro.api import ResultSet as RResultSet
from repro.api import Study as RStudy
from repro.api import summarize as r_summarize
from repro.sim import prep as RP
from repro.sim.engine import run_all as r_run_all
from repro.sim.trace import make_trace as r_make_trace
from repro_torch.api import (
    MECHANISMS,
    HWParams,
    LazyPIMConfig,
    ResultSet,
    Study,
    grid,
    make_trace,
    prepare,
    run_all,
    run_batch,
    run_sweep,
    summarize,
)
from repro_torch.core.coherence import _lazypim_acc
from repro_torch.core.mechanisms import ResultIntegrityError, finalize_result
from repro_torch.sim.costmodel import hw_leaf_dtypes
from repro_torch.sim.engine import stack_hw, stack_lazy, stack_traces
from repro_torch.sim.mesh import MESH_ENV_VAR
from repro_torch.sim.study import Dispatch
from repro_torch.sim.trace import trace_from_numpy


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's small CPU tensor ops on one thread: with several
    test workers on one host, torch's default thread pool per worker
    oversubscribes the cores and slows every worker down."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


EVENT_KEYS = ("commits", "conflicts_sig", "conflicts_exact", "rollbacks",
              "flush_lines", "dbi_writebacks")
RAW_RTOL = 1e-4
RATIO_RTOL = 1e-6
CPU = "cpu"


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def assert_close_to_reference(got: dict, want: dict, hw_r, hw_t, label: str):
    """Event counts exact, raw accumulators 1e-4, summarize ratios 1e-6."""
    for m, r in want.items():
        a, b = dataclasses.asdict(got[m]), dataclasses.asdict(r)
        for key, v in b.items():
            if key in EVENT_KEYS or isinstance(v, str):
                assert a[key] == v, f"{label}/{m}/{key}: {a[key]} vs {v}"
            else:
                assert _rel(a[key], v) < RAW_RTOL, f"{label}/{m}/{key}"
    if "cpu" in want:
        s_got, s_want = summarize(got, hw_t), r_summarize(want, hw_r)
        for m in want:
            for key in ("speedup", "traffic", "energy"):
                assert _rel(s_got[m][key], s_want[m][key]) < RATIO_RTOL, \
                    f"{label}/{m}/{key}"


@pytest.fixture(scope="module")
def pairs():
    """(reference, port) prepared small traces: a conflict-heavy graph app
    and an HTAP table workload, built once by the reference."""
    out = []
    for app, g, kw in (("components", "arxiv", dict(num_kernels=6)),
                       ("htap256", None, dict(num_kernels=5, scale=0.002))):
        rt = r_make_trace(app, g, **kw)
        fields = {f.name: np.asarray(getattr(rt, f.name))
                  for f in dataclasses.fields(rt)}
        out.append((RP.prepare(rt),
                    prepare(trace_from_numpy(fields, CPU), device=CPU)))
    return out


LAZY_CASES = {
    "partial": dict(),
    "full_commit": dict(partial_commits=False),
    "no_dbi_tight": dict(use_dbi=False, commit_exposure=0.5),
    "dbi_small_batches": dict(dbi_interval_cycles=200.0, dbi_lines_per_fire=3),
}


@pytest.mark.parametrize("case", list(LAZY_CASES))
def test_every_mechanism_equals_reference(pairs, case):
    hw = dict(thread_cache_cap=64, cpu_only_cache_cap=32)  # evictions run
    seen_conflicts = seen_dbi = 0.0
    for rtt, ttt in pairs:
        want = r_run_all(rtt, RP.HWParams(**hw), lazy_cfg=RLazy(**LAZY_CASES[case]))
        got = run_all(ttt, HWParams(**hw), lazy_cfg=LazyPIMConfig(**LAZY_CASES[case]),
                      device=CPU)
        assert set(got) == set(MECHANISMS)
        assert_close_to_reference(got, want, RP.HWParams(**hw), HWParams(**hw),
                                  f"{rtt.name}/{case}")
        seen_conflicts += got["lazypim"].conflicts_sig
        seen_dbi += got["lazypim"].dbi_writebacks
    assert seen_conflicts > 0  # the conflict / rollback path ran
    if case != "no_dbi_tight":
        assert seen_dbi > 0


@pytest.fixture(scope="module")
def grid_study_results(pairs):
    tts = [t for _, t in pairs]
    kw = dict(workloads=tts, hw=grid(offchip_bw_gbs=[16.0, 64.0]),
              lazy=[LazyPIMConfig(), LazyPIMConfig(dbi_interval_cycles=400.0)],
              device=CPU)
    return Study(**kw).run("batch"), Study(**kw).run("sequential")


def test_batch_equals_sequential_exactly(grid_study_results):
    batch, seq = grid_study_results
    assert len(batch) == len(seq) == 2 * 2 * 2
    for a, b in zip(batch.points, seq.points):
        assert (a.workload, a.hw_index, a.lazy_index) == \
            (b.workload, b.hw_index, b.lazy_index)
        for m in MECHANISMS:
            assert dataclasses.asdict(a.results[m]) == dataclasses.asdict(b.results[m])


def test_run_batch_and_sweep_equal_run_all(pairs):
    tts = [t for _, t in pairs]
    hws = [HWParams(), HWParams(pim_cores=8)]
    batched = run_batch(tts, hws, device=CPU)
    for t, h, res in zip(tts, hws, batched):
        assert res == run_all(t, h, device=CPU)
    t = tts[1]
    points = run_sweep(stack_traces([t, t]), stack_hw(hws, CPU), device=CPU)
    for h, res in zip(hws, points):
        assert res == run_all(t, h, device=CPU)


def test_plan_equals_reference(pairs):
    r_tts = [r for r, _ in pairs] * 2
    t_tts = [t for _, t in pairs] * 2
    from repro.api import grid as r_grid

    want = RStudy(workloads=r_tts, hw=r_grid(pim_cores=[8, 16, 32])).plan(devices=1)
    got = Study(workloads=t_tts, hw=grid(pim_cores=[8, 16, 32]), device=CPU).plan()
    assert got.num_points == want.num_points == 12
    assert got.buckets == want.buckets
    assert got.num_buckets == want.num_buckets
    assert "nothing is compiled" in got.describe()


def _rows(rs):
    """Rows in a canonical order (JSON files store mechanisms sorted)."""
    return sorted(rs.to_rows(), key=lambda r: (r["workload"], r["hw_index"],
                                               r["lazy_index"], r["mechanism"]))


def test_resultset_json_loads_across_packages(tmp_path, grid_study_results):
    """A port-saved file loads in the reference, a reference-saved file
    loads in the port (the fig12 golden is another reference-saved file)."""
    batch, _ = grid_study_results
    batch.save_json(tmp_path / "port.json")
    as_ref = RResultSet.load_json(tmp_path / "port.json")
    index = ("workload", "hw_index", "lazy_index")
    assert as_ref.pivot(index, "mechanism", "time_ns") == \
        batch.pivot(index, "mechanism", "time_ns")
    assert as_ref.normalized() == batch.normalized()
    as_ref.save_json(tmp_path / "ref.json")
    back = ResultSet.load_json(tmp_path / "ref.json")
    assert _rows(back) == _rows(batch)
    assert [p.hw for p in back] == [p.hw for p in batch]
    assert [p.lazy for p in back] == [p.lazy for p in batch]


def test_on_dispatch_boundary(pairs):
    tts = [t for _, t in pairs]
    seen = []

    def boundary(d: Dispatch, thunk):
        seen.append(d)
        return thunk()

    Study(tts, mechanisms=("cpu", "lazypim"), device=CPU).run(on_dispatch=boundary)
    assert [(d.engine, d.mechanism) for d in seen] == \
        [("batch", "cpu"), ("batch", "lazypim")] * 2
    seen.clear()
    Study(tts, mechanisms=("nc",), device=CPU).run("sequential", on_dispatch=boundary)
    assert [d.workload for d in seen] == [t.name for t in tts]

    def cancel(d, thunk):
        raise TimeoutError(d.mechanism)

    with pytest.raises(TimeoutError, match="fg"):
        Study(tts, mechanisms=("fg",), device=CPU).run(on_dispatch=cancel)


def test_study_rejects_bad_specs(pairs, monkeypatch):
    tts = [t for _, t in pairs]
    for bad, match in ((["nosuchapp"], "unknown app"),
                       (["capture/no_such_adapter"], "unknown capture spec"),
                       (["pagerank"], "graph input"),
                       (["htap128-arxiv"], "table workload")):
        with pytest.raises(ValueError, match=match):
            Study(bad, device=CPU)
    with pytest.raises(ValueError, match="mechanism"):
        Study(tts, mechanisms=("mesi",), device=CPU)
    with pytest.raises(ValueError, match="hw list length"):
        Study(tts, hw=[HWParams()], device=CPU)
    with pytest.raises(ValueError, match="static flag"):
        Study(tts, lazy=[LazyPIMConfig(), LazyPIMConfig(partial_commits=False)],
              device=CPU)
    with pytest.raises(ValueError, match="unknown HWParams field"):
        grid(no_such_field=[1])
    study = Study(tts, mechanisms=("cpu",), device=CPU)
    with pytest.raises(ValueError, match="engine"):
        study.run("warp")
    # the CPU shows one device unless XLA_FORCE_HOST_PLATFORM_DEVICE_COUNT says more
    monkeypatch.delenv(MESH_ENV_VAR, raising=False)
    with pytest.raises(ValueError, match="devices=2 but only 1 visible"):
        study.run(devices=2)
    with pytest.raises(ValueError, match="devices=4 but only 1 visible"):
        study.plan(devices=4)


def test_stacking_dtypes_and_static_flags():
    shw = stack_hw([HWParams(), HWParams(offchip_bw_gbs=16, pim_cores=8)], CPU)
    for name, dt in hw_leaf_dtypes().items():
        assert getattr(shw, name).dtype == dt, name
    assert shw.offchip_bw_gbs.tolist() == [32.0, 16.0]
    scfg = stack_lazy([LazyPIMConfig(), LazyPIMConfig(dbi_lines_per_fire=7)], CPU)
    assert scfg.dbi_lines_per_fire.dtype == torch.int32
    assert scfg.partial_commits is True
    with pytest.raises(ValueError, match="static"):
        stack_lazy([LazyPIMConfig(), LazyPIMConfig(max_rollbacks=5)], CPU)


def test_cpuws_register_check_kept(pairs):
    _, t = pairs[0]
    st = stack_traces([t])
    with pytest.raises(NotImplementedError, match="cpuws_regs"):
        _lazypim_acc(st, stack_hw([HWParams()], CPU),
                     stack_lazy([LazyPIMConfig(cpuws_regs=8)], CPU))


def test_finalize_result_integrity_sentinel():
    ok = finalize_result("w", "cpu", dict(time_ns=1.0, offchip_bytes=0.0,
                                          dram_bytes=0.0, l1_accesses=0.0,
                                          l2_accesses=0.0))
    assert ok.time_ns == 1.0 and ok.conflict_rate == 0.0
    for bad in (float("nan"), float("inf"), -1.0):
        with pytest.raises(ResultIntegrityError):
            finalize_result("w", "cpu", dict(time_ns=bad, offchip_bytes=0.0,
                                             dram_bytes=0.0, l1_accesses=0.0,
                                             l2_accesses=0.0))


def test_entry_points_default_to_cuda(pairs):
    """``device=None`` means the CUDA card: without one every entry point
    raises instead of running on the CPU; ``device="cpu"`` is explicit."""
    _, t = pairs[0]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs there")
    for call in (lambda: Study(["pagerank-arxiv"]),
                 lambda: make_trace("pagerank", "arxiv"),
                 lambda: run_all(t),
                 lambda: run_batch([t]),
                 lambda: run_sweep(stack_traces([t]), stack_hw([HWParams()], CPU))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    study = Study([t], mechanisms=("cpu",), device=CPU)
    with pytest.raises(RuntimeError):
        study.run(device="cuda")
