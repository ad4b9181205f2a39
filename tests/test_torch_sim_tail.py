"""The last public names of ``repro.sim`` in the port, held to ``repro`` on
the CPU: ``synth.generator`` (and ``synthesize``, which runs through it) on
every synthesized family, ``mesh.force_host_device_count`` for unset,
numeric and non-numeric values, and the layout line helpers
(``GraphLayout.vertex_line`` / ``frontier_line`` / ``edge_line``,
``IMDBLayout.tuple_line``) on random ids, as numpy arrays and as int
tensors."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from repro.sim import graphs as RG
from repro.sim import mesh as RM
from repro.sim import synth as RS
from repro.sim.trace import build_plan as r_build_plan
from repro_torch.sim import graphs as TG
from repro_torch.sim import mesh as TM
from repro_torch.sim import synth as TS
from repro_torch.sim.trace import build_plan as t_build_plan

CPU = "cpu"

# one workload of every synthesized family: graph apps, frontier kernels,
# the paper's HTAP, streaming ingest, the two-tenant mix
FAMILIES = [("pagerank", "enron"), ("bfs", "arxiv"), ("sssp", "enron"),
            ("htap256", None), ("htap_stream", None), ("mtmix", "enron")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("app,graph", FAMILIES, ids=[a for a, _ in FAMILIES])
def test_generator_equals_reference(app, graph):
    """``fn(*args)`` of the port's generator equals the reference
    generator's output field by field, at two seeds through one ``fn``
    (the keys are arguments), and ``synthesize`` gives the same."""
    kw = dict(threads=16, num_kernels=3, seed=0)
    rplan, redges, _ = r_build_plan(app, graph, **kw)
    tplan, tedges, _ = t_build_plan(app, graph, **kw)
    fn, args = TS.generator(tplan, seed=0, edges=tedges, device=CPU)
    for seed in (0, 5):
        rfn, rargs = RS.generator(rplan, seed=seed, edges=redges)
        want = {k: np.asarray(v) for k, v in rfn(*rargs).items()}
        if seed:
            _, args = TS.generator(tplan, seed=seed, edges=tedges, device=CPU)
        got = fn(*args)
        synth = TS.synthesize(tplan, seed, tedges, device=CPU)
        assert got.keys() == want.keys() == synth.keys()
        for k, w in want.items():
            g = got[k].numpy()
            assert g.shape == w.shape and np.array_equal(g.astype(w.dtype), w), (app, seed, k)
            assert torch.equal(synth[k], got[k]), (app, seed, k)


def test_generator_defaults_to_the_card():
    plan, _, _ = t_build_plan("htap128", num_kernels=2)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is legitimate here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.generator(plan)


@pytest.mark.parametrize("value", [None, "", "4", "1", "x4"],
                         ids=["unset", "empty", "four", "one", "non-numeric"])
def test_force_host_device_count_as_reference(monkeypatch, value):
    """Unset or empty: ``None`` (the reference sets no flag); a number: that
    count (the reference writes it into ``XLA_FLAGS``); anything else:
    ``ValueError`` from both."""
    monkeypatch.delenv("XLA_FLAGS", raising=False)
    if value is None:
        monkeypatch.delenv(TM.MESH_ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(TM.MESH_ENV_VAR, value)
    if value == "x4":
        with pytest.raises(ValueError):
            RM.force_host_device_count()
        with pytest.raises(ValueError):
            TM.force_host_device_count()
        return
    RM.force_host_device_count()
    flags = os.environ.get("XLA_FLAGS", "")
    got = TM.force_host_device_count()
    if value:
        assert got == int(value)
        assert flags == f"--xla_force_host_platform_device_count={value}"
        assert TM.available_devices(CPU) == int(value)
    else:
        assert got is None and flags == ""
        assert TM.available_devices(CPU) == 1
    assert "force_host_device_count" in TM.__all__


@pytest.mark.parametrize("graph", ["arxiv", "enron"])
def test_graph_layout_lines_equal_reference(graph):
    g = RG.make_graph(graph)
    ref, ours = RG.layout_for_graph(g), TG.layout_for_graph(TG.make_graph(graph))
    rng = np.random.default_rng(0)
    v = rng.integers(0, g.num_nodes, 4096)
    e = rng.integers(0, g.num_edges, 4096)
    for base in (ref.p_curr_base, ref.p_next_base):
        want = ref.vertex_line(base, v)
        np.testing.assert_array_equal(ours.vertex_line(base, v), want)
        assert torch.equal(ours.vertex_line(base, torch.from_numpy(v)), torch.from_numpy(want))
    for name, ids in (("frontier_line", v), ("edge_line", e)):
        want = getattr(ref, name)(ids)
        np.testing.assert_array_equal(getattr(ours, name)(ids), want)
        assert torch.equal(getattr(ours, name)(torch.from_numpy(ids)), torch.from_numpy(want))


@pytest.mark.parametrize("scale", [1.0, 0.01])
def test_imdb_tuple_line_equals_reference(scale):
    ref, ours = RG.make_imdb_layout(scale), TG.make_imdb_layout(scale)
    rng = np.random.default_rng(1)
    table = rng.integers(0, ref.tables, 4096)
    tup = rng.integers(0, int(ref.tuples_per_table * scale), 4096)
    field = rng.integers(0, ref.tuple_lines, 4096)
    want = ref.tuple_line(table, tup, field)
    np.testing.assert_array_equal(ours.tuple_line(table, tup, field), want)
    got = ours.tuple_line(*(torch.from_numpy(a) for a in (table, tup, field)))
    assert torch.equal(got, torch.from_numpy(want))
