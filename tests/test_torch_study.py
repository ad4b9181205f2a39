"""The port's ``Study`` API on the CPU, mirroring ``tests/test_study.py``:
spec validation (every bad entry fails at construction, named), grid
order, cross-engine bit-exactness of the folded hw / lazy axes, zipped hw
lists, prepared traces and a per-entry ``spec``, the unknown-engine and
missing-baseline errors, the ``ResultSet`` container (``to_rows`` /
``pivot`` / ``normalized`` / ``concat`` / save-load) and the stacking
helpers.  Grid labels and ``HWParams`` defaults are held to ``repro``'s;
``tests/test_torch_engine.py`` holds a study's results to ``repro``'s.

The compile budget: the port compiles nothing, and counts the distinct
dispatch shapes its batched dispatches ran (``sweep_cache_sizes``, the
reference's jit-cache count); ``test_measured_compiles_within_plan`` holds
their deltas to ``plan().compiles_per_mechanism`` in this process, and
``test_cold_dispatch_shapes_equal_plan`` to equality in a fresh one (the
reference's ``benchmarks/check_budget.py --live``).
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys
import typing

import pytest
import torch

from repro.api import HWParams as RHWParams
from repro.api import LazyPIMConfig as RLazyPIMConfig
from repro.api import Study as RStudy
from repro.api import grid as r_grid
from repro.api import workload as r_workload
from repro_torch.api import (
    HWParams,
    LazyPIMConfig,
    ResultSet,
    SignatureSpec,
    Study,
    grid,
    make_trace,
    prepare,
    run_all,
    sweep_cache_sizes,
    workload,
)
from repro_torch.core.mechanisms import finalize_result
from repro_torch.sim.costmodel import _HW_INT_FIELDS, hw_leaf_dtypes
from repro_torch.sim.engine import stack_hw, stack_lazy

CPU = "cpu"
SMALL = dict(num_kernels=3, windows_per_kernel=2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _small_study(**kw):
    kw.setdefault("workloads", [workload("pagerank", "arxiv", scale=0.4, **SMALL),
                                workload("htap128", scale=0.004, **SMALL)])
    kw.setdefault("mechanisms", ("cpu", "cg", "lazypim"))
    kw.setdefault("device", CPU)
    return Study(**kw)


def _assert_equal(a, b, label):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys(), label
    for k in da:
        assert da[k] == db[k], f"{label}: field {k}: {da[k]} != {db[k]}"


# ---------------------------------------------------------------------------
# Spec validation: every bad entry fails at construction, named
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(workloads=["htap128", "nosuch-arxiv"]), r"workloads\[1\].*'nosuch-arxiv'"),
    (dict(workloads=["pagerank"]), r"workloads\[0\].*needs a graph input"),
    (dict(workloads=[("htap128", "enron")]), r"workloads\[0\].*table workload"),
    (dict(workloads=["htap128"], mechanisms=("cpu", "warp")), r"mechanisms\[1\].*'warp'"),
    (dict(workloads=["htap128", ("pagerank", "arxiv")], hw=[HWParams()]),
     r"hw list length 1 != 2 workloads"),
    (dict(workloads=["htap128"],
          lazy=[LazyPIMConfig(), LazyPIMConfig(partial_commits=False)]),
     r"lazy\[1\].*partial_commits"),
    (dict(workloads=["htap128"],
          lazy=[LazyPIMConfig(), LazyPIMConfig(dbi_interval_cycles=3200.0),
                LazyPIMConfig(max_rollbacks=5)]),
     r"lazy\[2\].*max_rollbacks"),
], ids=["unknown-workload", "graph-without-input", "table-with-graph",
        "unknown-mechanism", "mismatched-hw-list", "mixed-partial-commits",
        "mixed-max-rollbacks"])
def test_bad_spec_rejected(kw, match):
    with pytest.raises(ValueError, match=match):
        Study(device=CPU, **kw)


def test_grid_unknown_field_rejected():
    with pytest.raises(ValueError, match=r"unknown HWParams field 'warp_size'"):
        grid(warp_size=[16, 32])


def test_grid_points_cross_product_order():
    g = grid(offchip_bw_gbs=[16.0, 32.0], pim_cores=[8, 16])
    pts = g.points()
    assert [(p.offchip_bw_gbs, p.pim_cores) for p in pts] == \
        [(16.0, 8), (16.0, 16), (32.0, 8), (32.0, 16)]
    assert g.labels()[2] == {"offchip_bw_gbs": 32.0, "pim_cores": 8}
    rg = r_grid(offchip_bw_gbs=[16.0, 32.0], pim_cores=[8, 16])
    assert g.labels() == rg.labels()


# ---------------------------------------------------------------------------
# A fig8-style hw-grid study (2 workloads x 3 bandwidths x 2 DBI settings)
# on both engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hw_grid_study():
    """The study, its plan, its batch and sequential results and the
    ``sweep_cache_sizes`` deltas of its batch run."""
    lazy = [LazyPIMConfig(use_dbi=True), LazyPIMConfig(use_dbi=False)]
    study = _small_study(hw=grid(offchip_bw_gbs=[16.0, 32.0, 64.0]), lazy=lazy)
    plan = study.plan()
    before = sweep_cache_sizes()
    results = study.run()
    after = sweep_cache_sizes()
    deltas = {m: after[m] - before[m] for m in study.mechanisms}
    return study, plan, results, study.run(engine="sequential"), deltas


def test_plan_shape(hw_grid_study):
    study, plan, results, _, _ = hw_grid_study
    assert plan.num_points == 2 * 3 * 2 == len(results.points)
    assert plan.num_buckets == 2  # pagerank-arxiv and htap128 buckets
    assert plan.compiles_per_mechanism == {m: 2 for m in study.mechanisms}
    assert plan.total_compiles == 6
    assert sum(b["lanes"] for b in plan.buckets) == plan.num_points
    assert "geometry buckets" in plan.describe()
    assert "<= 6 dispatch shapes" in plan.describe()


def test_measured_compiles_within_plan(hw_grid_study):
    """At most one new dispatch shape per (mechanism, bucket), whatever the
    hw x lazy cross-product size (shapes this process ran before can only
    lower the deltas; exact equality in a fresh process is
    ``test_cold_dispatch_shapes_equal_plan``)."""
    _, plan, _, _, deltas = hw_grid_study
    for m, d in deltas.items():
        assert d <= plan.compiles_per_mechanism[m], (m, d, plan.buckets)


_COLD_BUDGET = """
from repro_torch.api import LazyPIMConfig, Study, grid, sweep_cache_sizes, workload
from repro_torch.sim.engine import sequential_cache_sizes

SMALL = dict(num_kernels=3, windows_per_kernel=2)
study = Study(workloads=[workload("pagerank", "arxiv", scale=0.4, **SMALL),
                         workload("htap128", scale=0.004, **SMALL)],
              hw=grid(offchip_bw_gbs=[16.0, 32.0, 64.0]), mechanisms=("cpu", "cg", "lazypim"),
              lazy=[LazyPIMConfig(use_dbi=True), LazyPIMConfig(use_dbi=False)], device="cpu")
plan = study.plan()
assert sweep_cache_sizes() == {m: 0 for m in sweep_cache_sizes()}
study.run()
got = {m: n for m, n in sweep_cache_sizes().items() if n}
assert got == plan.compiles_per_mechanism, (got, plan.compiles_per_mechanism)
study.run()
assert {m: n for m, n in sweep_cache_sizes().items() if n} == got, "a warm rerun added shapes"
assert sequential_cache_sizes() == {m: 0 for m in got} | {"fg": 0, "nc": 0, "ideal": 0}
study.run(engine="sequential")
seq = sequential_cache_sizes()
assert {m: seq[m] for m in got} == plan.compiles_per_mechanism, seq
print("COLD-OK")
"""


def test_cold_dispatch_shapes_equal_plan():
    """In a fresh process the batch run's ``sweep_cache_sizes`` deltas equal
    ``plan().compiles_per_mechanism`` exactly, a warm rerun adds none, and
    the sequential engine's per-trace shapes (one per distinct geometry:
    two workloads) stay apart from the batched ones."""
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _COLD_BUDGET], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "COLD-OK" in out.stdout, out.stderr[-2000:]


def test_plan_budget_equals_reference():
    """``compiles_per_mechanism``, ``total_compiles`` and ``num_buckets``
    equal the reference plan's on the same spec, with and without the hw x
    lazy axes."""
    small = dict(num_kernels=3, windows_per_kernel=2)
    mech = ("cpu", "cg", "lazypim")
    hw = [16.0, 32.0, 64.0]
    ours = _small_study(hw=grid(offchip_bw_gbs=hw),
                        lazy=[LazyPIMConfig(use_dbi=True), LazyPIMConfig(use_dbi=False)])
    ref = RStudy(workloads=[r_workload("pagerank", "arxiv", scale=0.4, **small),
                            r_workload("htap128", scale=0.004, **small)],
                 mechanisms=mech, hw=r_grid(offchip_bw_gbs=hw),
                 lazy=[RLazyPIMConfig(use_dbi=True), RLazyPIMConfig(use_dbi=False)])
    for a, b in ((ours.plan(), ref.plan()), (_small_study().plan(), RStudy(
            workloads=ref.workloads, mechanisms=mech).plan())):
        assert a.num_buckets == b.num_buckets
        assert a.compiles_per_mechanism == b.compiles_per_mechanism
        assert a.total_compiles == b.total_compiles


def test_batched_study_bit_exact_vs_sequential(hw_grid_study):
    study, _, results, seq, _ = hw_grid_study
    assert len(results.points) == len(seq.points)
    for bp, sp in zip(results.points, seq.points):
        assert (bp.workload, bp.hw_index, bp.lazy_index) == \
            (sp.workload, sp.hw_index, sp.lazy_index)
        for m in study.mechanisms:
            _assert_equal(sp.results[m], bp.results[m],
                          f"{bp.workload}/hw{bp.hw_index}/lz{bp.lazy_index}/{m}")


def test_zipped_hw_list_matches_sequential():
    wls = [workload("pagerank", "arxiv", threads=t, scale=0.4, **SMALL) for t in (4, 16)]
    hws = [HWParams(cpu_cores=t, pim_cores=t) for t in (4, 16)]
    study = Study(workloads=wls, hw=hws, mechanisms=("cpu", "lazypim"), device=CPU)
    rs = study.run()
    for i, p in enumerate(rs.points):
        assert p.hw_index == i and p.hw is hws[i]
        seq = run_all(study.traces()[i], hws[i], ("cpu", "lazypim"), device=CPU)
        for m in ("cpu", "lazypim"):
            _assert_equal(seq[m], p.results[m], f"zipped[{i}]/{m}")


def test_prepared_traces_and_per_entry_spec():
    tt = prepare(make_trace("pagerank", "arxiv", scale=0.4, device=CPU, **SMALL),
                 device=CPU)
    rs = Study(workloads=[tt], mechanisms=("cpu",), device=CPU).run()
    assert rs.points[0].workload == "pagerank-arxiv"
    spec = SignatureSpec(sig_bits=4096)
    study = Study(workloads=[workload("htap128", spec=spec, scale=0.004, **SMALL)],
                  mechanisms=("lazypim",), device=CPU)
    assert study.traces()[0].spec == spec
    _assert_equal(run_all(study.traces()[0], HWParams(), ("lazypim",),
                          device=CPU)["lazypim"],
                  study.run().points[0].results["lazypim"], "spec-override")


def test_unknown_engine_rejected():
    with pytest.raises(ValueError, match="unknown engine 'warp'"):
        _small_study().run(engine="warp")


# ---------------------------------------------------------------------------
# ResultSet container
# ---------------------------------------------------------------------------


def test_resultset_rows_pivot_normalized(hw_grid_study):
    study, _, results, _, _ = hw_grid_study
    rows = results.to_rows()
    assert len(rows) == len(results.points) * len(study.mechanisms)
    assert {r["mechanism"] for r in rows} == set(study.mechanisms)
    assert all(r["speedup"] == 1.0 for r in rows if r["mechanism"] == "cpu")
    table = results.pivot(("workload", "hw_index", "lazy_index"), "mechanism", "speedup")
    assert len(table) == len(results.points)
    norm = results.normalized()
    for p, s in zip(results.points, norm):
        key = (p.workload, p.hw_index, p.lazy_index)
        assert table[key]["lazypim"] == s["lazypim"]["speedup"]
    with pytest.raises(ValueError, match="duplicate cell"):
        results.pivot("workload", "mechanism", "speedup")


def test_normalized_requires_baseline():
    rs = _small_study(workloads=[workload("htap128", scale=0.004, **SMALL)],
                      mechanisms=("lazypim",)).run()
    with pytest.raises(ValueError, match="needs 'cpu'"):
        rs.normalized()


def test_resultset_save_load_round_trip(tmp_path, hw_grid_study):
    _, _, results, _, _ = hw_grid_study
    loaded = ResultSet.load_json(results.save_json(tmp_path / "rs.json"))
    assert loaded.mechanisms == results.mechanisms
    assert len(loaded.points) == len(results.points)
    for a, b in zip(results.points, loaded.points):
        assert (a.workload, a.hw_index, a.lazy_index) == \
            (b.workload, b.hw_index, b.lazy_index)
        assert a.hw == b.hw and a.lazy == b.lazy
        for m in a.results:
            _assert_equal(a.results[m], b.results[m], f"reload/{m}")


def test_resultset_concat(hw_grid_study):
    _, _, results, _, _ = hw_grid_study
    both = ResultSet.concat([results, results])
    assert len(both) == 2 * len(results)
    assert both.mechanisms == results.mechanisms


# ---------------------------------------------------------------------------
# Stacking helpers: declared dtypes and static-flag discipline
# ---------------------------------------------------------------------------


def test_stack_hw_round_trips_every_field_at_declared_dtype():
    hints = typing.get_type_hints(HWParams)
    assert {n for n, t in hints.items() if t is int} == set(_HW_INT_FIELDS)
    assert dataclasses.asdict(HWParams()) == dataclasses.asdict(RHWParams())
    dtypes = hw_leaf_dtypes()
    a = HWParams()
    b = HWParams(offchip_bw_gbs=16, cpu_cores=8, freq_ghz=2.5, nc_bytes=64)
    stacked = stack_hw([a, b], CPU)
    assert set(dtypes) == {f.name for f in dataclasses.fields(HWParams)}
    for name, dt in dtypes.items():
        leaf = getattr(stacked, name)
        assert leaf.shape == (2,) and leaf.dtype == dt, name
        want = torch.tensor([getattr(a, name), getattr(b, name)], dtype=dt)
        assert torch.equal(leaf, want), name
    assert float(stacked.offchip_bw_gbs[1]) == 16.0
    assert stacked.offchip_bw_gbs.dtype == torch.float32


def test_stack_lazy_stacks_traced_knobs_and_rejects_static_mix():
    cfgs = [LazyPIMConfig(dbi_interval_cycles=1600.0),
            LazyPIMConfig(dbi_interval_cycles=3200.0, use_dbi=False)]
    s = stack_lazy(cfgs, CPU)
    assert s.partial_commits is True and s.cpuws_regs == 16
    assert torch.equal(s.dbi_interval_cycles,
                       torch.tensor([1600.0, 3200.0], dtype=torch.float32))
    assert torch.equal(s.use_dbi, torch.tensor([True, False]))
    with pytest.raises(ValueError, match=r"\[1\].*partial_commits"):
        stack_lazy([LazyPIMConfig(), LazyPIMConfig(partial_commits=False)], CPU)


def test_finalize_result_is_the_single_constructor():
    tt = prepare(make_trace("pagerank", "arxiv", scale=0.4, device=CPU, **SMALL),
                 device=CPU)
    r = run_all(tt, HWParams(), ("cg",), device=CPU)["cg"]
    rebuilt = finalize_result(tt.name, "cg", {
        k: getattr(r, k) for k in (
            "time_ns", "offchip_bytes", "dram_bytes", "l1_accesses",
            "l2_accesses", "flush_lines", "blocked_accesses")})
    assert rebuilt.name == r.name and rebuilt.time_ns == r.time_ns
