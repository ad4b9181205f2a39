"""The extended trace families of repro_torch held against repro's on the
CPU (mirroring ``tests/test_trace_synth.py``'s
``test_new_families_bit_identical`` and
``test_ref_backend_reaches_every_family``): the BFS/SSSP frontier kernels,
streaming-ingest HTAP and the two-tenant mix on every graph input, each
field of the port's ``backend="torch"`` and ``backend="ref"`` traces equal
to repro's ``backend="jax"`` and ``backend="ref"`` ones; the plans, the
two-tenant layout and the numpy Threefry of the port's reference equal
repro's; ``all_workloads(extended=True)`` is repro's 22.  Integer and
float32 fields, so every comparison is exact."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.sim import _traceref as RREF
from repro.sim import graphs as RG
from repro.sim import synth as RS
from repro.sim.trace import all_workloads as r_all_workloads
from repro.sim.trace import build_plan as r_build_plan
from repro.sim.trace import make_trace as r_make_trace
from repro_torch.sim import _traceref as TREF
from repro_torch.sim import graphs as TG
from repro_torch.sim import synth as TS
from repro_torch.sim.trace import all_workloads, build_plan, make_trace

EXTENDED = [w for w in r_all_workloads(extended=True) if w not in r_all_workloads()]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _assert_traces_equal(want, got, label):
    """Every WindowTrace field of ``got`` (a port trace) equals ``want``'s (a
    repro trace, or another port trace), dtype and shape included."""
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(g, torch.Tensor):
            w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
            assert g.numpy().dtype == w.dtype, f"{label}: {f.name} dtype"
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{label}: {f.name}")
        else:
            assert g == w, f"{label}: {f.name}: {g!r} != {w!r}"


def _four_traces(app, graph, **kw):
    """repro's jax and ref traces, the port's torch and ref traces."""
    return (r_make_trace(app, graph, **kw), r_make_trace(app, graph, backend="ref", **kw),
            make_trace(app, graph, device="cpu", **kw),
            make_trace(app, graph, device="cpu", backend="ref", **kw))


@pytest.mark.parametrize("app,graph", EXTENDED)
def test_extended_workload_equals_reference_at_full_size(app, graph):
    """Each of the 10 new workloads at the reference's defaults (16
    threads, 24 kernels x 3 windows, scale 1.0 / 0.01): both port backends
    equal both repro backends."""
    r_jax, r_ref, t_torch, t_ref = _four_traces(app, graph)
    label = f"{app}-{graph}"
    assert t_torch.num_windows == 72
    _assert_traces_equal(r_jax, t_torch, f"{label} torch vs jax")
    _assert_traces_equal(r_ref, t_ref, f"{label} ref vs repro ref")
    _assert_traces_equal(t_torch, t_ref, f"{label} torch vs ref")


@pytest.mark.parametrize("seed,threads", [(3, 16), (1, 8)])
@pytest.mark.parametrize("app,graph", [
    ("bfs", "arxiv"), ("sssp", "gnutella"), ("htap_stream", None), ("mtmix", "arxiv"),
])
def test_new_families_bit_identical(app, graph, seed, threads):
    """The reference test's reduced geometry (and one more seed / thread
    count): the port's two backends and repro's two agree."""
    kw = dict(threads=threads, seed=seed, num_kernels=4, windows_per_kernel=2)
    if graph is not None:
        kw["scale"] = 0.3
    r_jax, r_ref, t_torch, t_ref = _four_traces(app, graph, **kw)
    _assert_traces_equal(r_jax, t_torch, "torch vs jax")
    _assert_traces_equal(r_ref, t_ref, "ref vs repro ref")
    _assert_traces_equal(t_torch, t_ref, "torch vs ref")


@pytest.mark.parametrize("app,graph", [("pagerank", "arxiv"), ("htap192", None),
                                       ("components", "gnutella")])
def test_ref_backend_covers_the_paper_families(app, graph):
    kw = dict(num_kernels=5, scale=0.004) if graph is None else dict(num_kernels=5)
    r_jax, _, t_torch, t_ref = _four_traces(app, graph, **kw)
    _assert_traces_equal(r_jax, t_ref, "ref vs jax")
    _assert_traces_equal(t_torch, t_ref, "torch vs ref")


def test_ref_backend_reaches_every_family():
    """The numpy reference dispatches every plan type the tensor generator
    does, and the plan types are repro's."""
    plans = set(TS._EDGE_FNS) | set(TS._TABLE_FNS)
    assert set(TREF.ARRAY_FNS_REF) == plans
    assert {p.__name__ for p in plans} == {p.__name__ for p in RREF.ARRAY_FNS_REF}
    for p in plans:
        rp = getattr(RS, p.__name__)
        assert p.STREAMS == rp.STREAMS, p.__name__
        assert [f.name for f in dataclasses.fields(p)] == \
            [f.name for f in dataclasses.fields(rp)], p.__name__


OTHER_ARGS = dict(threads=4, num_kernels=7, windows_per_kernel=2, scale=0.5)


@pytest.mark.parametrize("app,graph,kw", [(a, g, {}) for a, g in EXTENDED] + [
    ("sssp", "arxiv", OTHER_ARGS), ("mtmix", "enron", OTHER_ARGS),
    ("htap_stream", None, dict(num_kernels=5, scale=0.02, cpu_reuse=3.0))])
def test_plans_equal_reference(app, graph, kw):
    """The host-side plans, field by field, at the defaults and at other
    arguments."""
    r_plan, r_edges, r_name = r_build_plan(app, graph, **kw)
    t_plan, t_edges, t_name = build_plan(app, graph, **kw)
    assert t_name == r_name and type(t_plan).__name__ == type(r_plan).__name__
    assert dataclasses.asdict(t_plan) == dataclasses.asdict(r_plan)
    assert (t_edges is None) == (r_edges is None)
    if t_edges is not None:
        np.testing.assert_array_equal(t_edges, r_edges)


@pytest.mark.parametrize("graph", ["enron", "arxiv", "gnutella"])
def test_mt_layout_equals_reference(graph):
    t, r = TG.mt_layout_for_graph(TG.make_graph(graph)), RG.mt_layout_for_graph(
        RG.make_graph(graph))
    names = ("a_pc", "a_pn", "a_fr", "tenant_lines", "b_pc", "b_pn", "b_fr",
             "edge_base", "total_lines")
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert [getattr(t, n) for n in names] == [getattr(r, n) for n in names]


def test_mtmix_needs_two_kernels():
    for build in (lambda: build_plan("mtmix", "arxiv", num_kernels=1),
                  lambda: make_trace("mtmix", "arxiv", num_kernels=1, device="cpu")):
        with pytest.raises(ValueError, match="num_kernels must be >= 2, got 1"):
            build()
    with pytest.raises(ValueError, match="num_kernels must be >= 2"):
        r_build_plan("mtmix", "arxiv", num_kernels=1)


def test_family_defaults_equal_reference():
    """Table families default to scale 0.01, streaming to cpu_reuse 8."""
    for app, graph in (("htap_stream", None), ("bfs", "enron"), ("mtmix", "gnutella")):
        t, r = make_trace(app, graph, num_kernels=2, device="cpu"), \
            r_make_trace(app, graph, num_kernels=2)
        assert (t.num_lines, t.cpu_reuse) == (r.num_lines, r.cpu_reuse)
    assert make_trace("htap_stream", num_kernels=2, device="cpu").cpu_reuse == 8.0


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend 'jax'"):
        make_trace("bfs", "arxiv", num_kernels=2, device="cpu", backend="jax")


def test_all_workloads_extended_is_the_reference_fleet():
    assert all_workloads(extended=True) == r_all_workloads(extended=True)
    assert len(all_workloads(extended=True)) == 22
    full = all_workloads(extended=True, captured=True)
    assert full == r_all_workloads(extended=True, captured=True)
    assert len(full) == 25


def test_numpy_threefry_equals_reference():
    """The port's numpy Threefry (its reference's own copy) equals repro's
    shared one and the port's tensor one."""
    rng = np.random.default_rng(5)
    c0 = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    c1 = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    for k0, k1 in ((0, 0), (0xDEADBEEF, 0x12345678), (2**32 - 1, 1)):
        want = RS.threefry2x32(np, np.uint32(k0), np.uint32(k1), c0, c1)
        got = TREF.threefry2x32(k0, k1, c0, c1)
        tensor = TS.threefry2x32(k0, k1, torch.from_numpy(c0.astype(np.int64)),
                                 torch.from_numpy(c1.astype(np.int64)))
        for w, g, t in zip(want, got, tensor):
            assert g.dtype == np.uint32
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(t.numpy(), w.astype(np.int64))
    key = RS.derive_key("mtmix", "enron", 2, "crsB")
    for bound in (7, 600, 2**31 + 5):
        np.testing.assert_array_equal(TREF.counter_mod(key, c0, bound),
                                      RS.counter_mod(np, key, c0, bound))
    np.testing.assert_array_equal(TREF.counter_u01(key, c0), RS.counter_u01(np, key, c0))
