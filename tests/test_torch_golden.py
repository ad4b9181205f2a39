"""The port reproduces the reference's committed goldens on the CPU, at the
goldens' size and tolerances (ratios 1e-6 relative, raw accumulators
1e-4, event counts exact), on both engines.  Reads the JSON artifacts
only: no JAX runs here.

* ``fig7_golden.json`` / ``fig7_batched_golden.json`` — ``summarize()`` of
  pagerank-arxiv and htap128 over the six mechanisms;
* ``fig12_golden.json`` — the partial- vs full-commit LazyPIM ablation, a
  ``ResultSet`` saved by the reference and loaded here by the port.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import pytest
import torch

from repro_torch.api import LazyPIMConfig, ResultSet, Study, summarize


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's small CPU tensor ops on one thread: with several
    test workers on one host, torch's default thread pool per worker
    oversubscribes the cores and slows every worker down."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
RATIO_KEYS = ("speedup", "traffic", "energy")
EVENT_KEYS = ("commits", "conflicts_sig", "conflicts_exact", "rollbacks",
              "flush_lines", "dbi_writebacks")
RATIO_RTOL = 1e-6
RAW_RTOL = 1e-4


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.fixture(scope="module", params=["sequential", "batch"])
def fig7(request):
    rs = Study(["pagerank-arxiv", "htap128"], device="cpu").run(engine=request.param)
    return request.param, {p.workload: summarize(p.results, p.hw) for p in rs}


@pytest.mark.parametrize("golden_file", ["fig7_golden.json",
                                         "fig7_batched_golden.json"])
def test_fig7_matches_golden(fig7, golden_file):
    engine, current = fig7
    golden = json.loads((GOLDEN_DIR / golden_file).read_text())
    assert set(current) == set(golden)
    for name, mechs in golden.items():
        assert set(current[name]) == set(mechs), name
        for mech, vals in mechs.items():
            for key, want in vals.items():
                got = current[name][mech][key]
                label = f"{engine}/{name}/{mech}/{key}: {got!r} vs {want!r}"
                if key in EVENT_KEYS:
                    assert got == want, label
                tol = RATIO_RTOL if key in RATIO_KEYS else RAW_RTOL
                assert _rel(got, want) < tol, label


@pytest.mark.parametrize("engine", ["batch", "sequential"])
def test_fig12_matches_golden(engine):
    golden = ResultSet.load_json(GOLDEN_DIR / "fig12_golden.json")
    wl = (("components", "enron"), ("htap128", None))
    current = ResultSet.concat([
        Study(wl, mechanisms=("lazypim",), lazy=LazyPIMConfig(partial_commits=p),
              device="cpu").run(engine=engine)
        for p in (True, False)])
    assert len(current) == len(golden) == 4
    for c, g in zip(current.points, golden.points):
        assert (c.workload, c.lazy.partial_commits) == \
            (g.workload, g.lazy.partial_commits)
        got = dataclasses.asdict(c.results["lazypim"])
        want = dataclasses.asdict(g.results["lazypim"])
        label = f"{engine}/{c.workload}/partial={c.lazy.partial_commits}"
        for key, gv in want.items():
            if isinstance(gv, str):
                assert got[key] == gv, label
            elif key in EVENT_KEYS:
                assert got[key] == gv, f"{label}/{key}"
            else:
                assert _rel(got[key], gv) < RAW_RTOL, f"{label}/{key}"
        cr, gr = c.results["lazypim"], g.results["lazypim"]
        assert _rel(cr.conflict_rate, gr.conflict_rate) < RATIO_RTOL, label
        assert _rel(cr.conflict_rate_exact, gr.conflict_rate_exact) < RATIO_RTOL
