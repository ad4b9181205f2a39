"""Trace synthesis of repro_torch held against repro's on the CPU: the same
Threefry bits, the same stream keys, and the same trace for each of the
paper's 12 workloads and for the extended families, field by field
(``tests/test_torch_synth_extended.py`` has the extended families in
full)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.sim import synth as RS
from repro.sim.trace import all_workloads as r_all_workloads
from repro.sim.trace import make_trace as r_make_trace
from repro_torch.sim import synth as TS
from repro_torch.sim.trace import CAPTURE_APPS, all_workloads, make_trace, trace_from_numpy


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's small CPU tensor ops on one thread: with several
    test workers on one host, torch's default thread pool per worker
    oversubscribes the cores and slows every worker down."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_threefry_bits_equal_reference():
    rng = np.random.default_rng(0)
    c0 = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    c1 = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    for k0, k1 in ((0, 0), (0xDEADBEEF, 0x12345678), (2**32 - 1, 1)):
        want = RS.threefry2x32(np, np.uint32(k0), np.uint32(k1), c0, c1)
        got = TS.threefry2x32(k0, k1, torch.from_numpy(c0.astype(np.int64)),
                              torch.from_numpy(c1.astype(np.int64)))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


def test_counter_draws_equal_reference():
    key = RS.derive_key("pagerank", "arxiv", 3, "e0")
    assert TS.derive_key("pagerank", "arxiv", 3, "e0") == tuple(int(k) for k in key)
    ctr = np.arange(5000, dtype=np.uint32) * np.uint32(2654435761)
    tctr = torch.from_numpy(ctr.astype(np.int64))
    np.testing.assert_array_equal(TS.counter_bits(key, tctr).numpy(),
                                  RS.counter_bits(np, key, ctr).astype(np.int64))
    np.testing.assert_array_equal(TS.counter_u01(key, tctr).numpy(),
                                  RS.counter_u01(np, key, ctr))
    for bound in (7, 10484, 2**31 + 5):
        np.testing.assert_array_equal(TS.counter_mod(key, tctr, bound).numpy(),
                                      RS.counter_mod(np, key, ctr, bound))
    np.testing.assert_array_equal(
        TS.derive_keys("htap128", None, 0, RS.HtapPlan.STREAMS),
        RS.derive_keys("htap128", None, 0, RS.HtapPlan.STREAMS))


def _assert_same_trace(r, t):
    for f in dataclasses.fields(r):
        want, got = getattr(r, f.name), getattr(t, f.name)
        if isinstance(got, torch.Tensor):
            want = np.asarray(want)
            assert got.shape == want.shape, f.name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)
        else:
            assert got == want, f.name


@pytest.mark.parametrize("app,graph", r_all_workloads())
def test_paper_workload_trace_equals_reference(app, graph):
    kw = dict(scale=0.002) if graph is None else {}
    r = r_make_trace(app, graph, num_kernels=6, **kw)
    t = make_trace(app, graph, num_kernels=6, device="cpu", **kw)
    assert t.name == r.name and t.num_windows == r.num_windows == 18
    _assert_same_trace(r, t)


def test_default_size_trace_equals_reference():
    """One workload at the goldens' full size (24 kernels x 3 windows)."""
    _assert_same_trace(r_make_trace("htap128", None),
                       make_trace("htap128", None, device="cpu"))


def test_trace_from_numpy_carries_a_reference_trace():
    r = r_make_trace("radii", "gnutella", num_kernels=3, seed=5)
    fields = {f.name: np.asarray(getattr(r, f.name)) for f in dataclasses.fields(r)}
    t = trace_from_numpy(fields, device="cpu")
    _assert_same_trace(r, t)
    assert t.pim_reads.dtype == torch.int32 and t.pre_writes.dtype == torch.bool
    del fields["pim_reads"]
    with pytest.raises(ValueError, match="pim_reads"):
        trace_from_numpy(fields, device="cpu")


def test_all_workloads_is_the_paper_set():
    """The paper's 12 by default, repro's 22 with ``extended=True``, and
    repro's captured set with ``captured=True``."""
    assert all_workloads() == r_all_workloads()
    assert all_workloads(extended=True) == r_all_workloads(extended=True)
    assert all_workloads(captured=True) == r_all_workloads(captured=True)
    assert all_workloads(captured=True)[-3:] == [(a, None) for a in CAPTURE_APPS]


@pytest.mark.parametrize("app,graph", [("bfs", "arxiv"), ("htap_stream", None),
                                       ("mtmix", "enron"), ("capture/moe_experts", None)])
def test_later_families_name_their_slice(app, graph):
    """The extended families and ``capture/moe_experts`` are ported and
    equal repro's traces."""
    if app.startswith("capture/"):
        kw = dict(num_kernels=4, scale=0.05)
    else:
        kw = dict(num_kernels=4, scale=0.002 if graph is None else 0.5)
    _assert_same_trace(r_make_trace(app, graph, **kw),
                       make_trace(app, graph, device="cpu", **kw))


def test_make_trace_defaults_to_cuda():
    if torch.cuda.is_available():
        assert make_trace("pagerank", "arxiv", num_kernels=1).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_trace("pagerank", "arxiv", num_kernels=1)
