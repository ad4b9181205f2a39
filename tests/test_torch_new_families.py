"""The extended workload families through the port's simulator on the CPU,
mirroring ``tests/test_new_families.py``: the paper's qualitative mechanism
ordering under the default ``HWParams`` (ideal >= lazypim >= {fg, cg}; NC
worst on the reuse-heavy mixes; LazyPIM within 25 % of ideal) and the
two-tenant mix's CPUWriteSet pressure, each case at full scale and held
to repro's results (event counts exact, ratios to the goldens' 1e-6, raw
accumulators to 1e-4); and ``tests/test_batch_engine.py``'s 22-workload
fleet at a reduced kernel count: ``run_batch`` equal to sequential
``run_all`` on every ``SimResult`` field, for every mechanism and both
LazyPIM commit modes, and to repro's results."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro.core.coherence import LazyPIMConfig as RLazy
from repro.core.coherence import simulate_lazypim as r_simulate_lazypim
from repro.sim.costmodel import HWParams as RHW
from repro.sim.engine import run_all as r_run_all
from repro.sim.engine import summarize as r_summarize
from repro.sim.prep import prepare as r_prepare
from repro.sim.trace import make_trace as r_make_trace
from repro_torch.core.coherence import LazyPIMConfig, simulate_lazypim
from repro_torch.sim.costmodel import HWParams
from repro_torch.sim.engine import MECHANISMS, run_all, run_batch, summarize
from repro_torch.sim.prep import prepare
from repro_torch.sim.trace import all_workloads, make_trace

HW, R_HW = HWParams(), RHW()
CPU = "cpu"
EVENT_KEYS = ("commits", "conflicts_sig", "conflicts_exact", "rollbacks",
              "flush_lines", "dbi_writebacks")
RATIO_KEYS = ("speedup", "traffic", "energy")
RATIO_RTOL, RAW_RTOL = 1e-6, 1e-4

# One full-scale representative per new family axis; the reuse-heavy mixes
# (where NC must come out worst) marked.
CASES = (
    ("bfs", "arxiv", False),
    ("sssp", "gnutella", False),
    ("htap_stream", None, True),
    ("mtmix", "arxiv", True),
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def case(request):
    app, graph, reuse_heavy = request.param
    tt = prepare(make_trace(app, graph, threads=16, device=CPU), device=CPU)
    return summarize(run_all(tt, HW, device=CPU), HW), reuse_heavy, tt.name, (app, graph)


def test_paper_qualitative_ordering(case):
    s, _, name, _ = case
    lz = s["lazypim"]["speedup"]
    assert s["ideal"]["speedup"] >= lz, name
    assert lz >= s["fg"]["speedup"], name
    assert lz >= s["cg"]["speedup"], name


def test_nc_worst_on_reuse_heavy(case):
    """NC loses to every other mechanism where the processor re-reads hot
    PIM data; on the other cases NC is at least not above ideal."""
    s, reuse_heavy, name, _ = case
    nc = s["nc"]["speedup"]
    others = ("cpu", "fg", "cg", "lazypim", "ideal") if reuse_heavy else ("ideal",)
    for m in others:
        assert nc < s[m]["speedup"] or (not reuse_heavy and nc <= s[m]["speedup"]), \
            f"{name}: nc not below {m}"


def test_lazypim_within_gap_of_ideal(case):
    s, _, name, _ = case
    assert 1 - s["lazypim"]["speedup"] / s["ideal"]["speedup"] < 0.25, name


def test_summary_equals_reference(case):
    """The same case through repro: event counts exact, ratios 1e-6, raw
    accumulators 1e-4."""
    s, _, name, (app, graph) = case
    want = r_summarize(r_run_all(r_prepare(r_make_trace(app, graph, threads=16)), R_HW),
                       R_HW)
    assert set(s) == set(want)
    for mech, vals in want.items():
        for key, w in vals.items():
            got = s[mech][key]
            if key in EVENT_KEYS:
                assert got == w, f"{name}/{mech}/{key}: {got} != {w}"
            elif isinstance(w, (int, float)):
                tol = RATIO_RTOL if key in RATIO_KEYS else RAW_RTOL
                assert abs(got - w) <= tol * max(abs(w), 1e-12), \
                    f"{name}/{mech}/{key}: {got} vs {w}"


def test_multi_tenant_signature_pressure():
    """mtmix's point: the inactive tenant's concurrent writes press on the
    CPUWriteSet.  Signature conflicts occur, include cross-tenant H3 false
    positives (so they are at least the exact RAW conflicts), and equal
    repro's counts."""
    tt = prepare(make_trace("mtmix", "gnutella", threads=16, device=CPU), device=CPU)
    r = simulate_lazypim(tt, HW, LazyPIMConfig(), device=CPU)
    assert r.conflicts_sig > 0
    assert r.conflicts_sig >= r.conflicts_exact
    want = r_simulate_lazypim(r_prepare(r_make_trace("mtmix", "gnutella", threads=16)),
                              R_HW, RLazy())
    for key in EVENT_KEYS:
        assert getattr(r, key) == getattr(want, key), key


# ---------------------------------------------------------------------------
# The 22-workload fleet on both engines (4 kernels x 3 windows a workload)
# ---------------------------------------------------------------------------

FLEET_KERNELS = 4


@pytest.fixture(scope="module")
def fleet():
    return [prepare(make_trace(app, g, threads=16, num_kernels=FLEET_KERNELS,
                               device=CPU), device=CPU)
            for app, g in all_workloads(extended=True)]


def _assert_equal(a, b, label):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys(), label
    for k in da:
        assert da[k] == db[k], f"{label}: field {k}: batch={db[k]} seq={da[k]}"


@pytest.mark.parametrize("partial", [True, False], ids=["partial", "full_commit"])
def test_batch_bit_exact_full_fleet(fleet, partial):
    """run_batch == sequential run_all on every field of 22 x 6 results."""
    cfg = LazyPIMConfig(partial_commits=partial)
    assert len(fleet) == 22
    results = run_batch(fleet, HW, lazy_cfg=cfg, device=CPU)
    for tt, br in zip(fleet, results):
        seq = run_all(tt, HW, lazy_cfg=cfg, device=CPU)
        assert set(br) == set(seq) == set(MECHANISMS)
        for m in MECHANISMS:
            _assert_equal(seq[m], br[m], f"{tt.name}/{m}")
            assert br[m].name == tt.name and br[m].mechanism == m


def test_fleet_equals_reference(fleet):
    """The extended workloads of the fleet equal repro's sequential results
    on every field."""
    for tt in fleet[12:]:
        app, _, graph = tt.name.partition("-")
        want = r_run_all(r_prepare(r_make_trace(app, graph or None, threads=16,
                                                num_kernels=FLEET_KERNELS)), R_HW)
        got = run_all(tt, HW, device=CPU)
        for m in MECHANISMS:
            da, db = dataclasses.asdict(got[m]), dataclasses.asdict(want[m])
            assert da == db, (tt.name, m, {k: (da[k], db[k]) for k in da if da[k] != db[k]})
