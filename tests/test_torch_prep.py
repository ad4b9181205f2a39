"""repro_torch.sim.prep held against repro.sim.prep on the CPU: every packed
primitive, trace staging, padding and bucketing — packed words compared as
uint32 bit patterns, the -1 sentinels and the zero pad bits checked."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import prep as RP
from repro.sim.costmodel import HWParams as RHW
from repro.sim.trace import make_trace as r_make_trace
from repro_torch.core.signatures import default_spec
from repro_torch.sim import prep as TP
from repro_torch.sim.costmodel import HWParams as THW
from repro_torch.sim.engine import stack_hw, stack_traces
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


def _port_trace(rt):
    fields = {f.name: np.asarray(getattr(rt, f.name)) for f in dataclasses.fields(rt)}
    return trace_from_numpy(fields, device="cpu")


@pytest.fixture(scope="module")
def traces():
    """(reference, port) prepared traces: a graph app and a small HTAP."""
    out = {}
    for app, g, kw in (("components", "arxiv", dict(num_kernels=4)),
                       ("htap192", None, dict(num_kernels=3, scale=0.002))):
        rt = r_make_trace(app, g, **kw)
        out[rt.name] = (RP.prepare(rt), TP.prepare(_port_trace(rt), device="cpu"))
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        a = x.numpy()
        return a.view(np.uint32) if a.dtype == np.int32 else a
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def assert_same_tensors(r, t):
    """Every field of two prepared traces (either package) is equal."""
    for f in dataclasses.fields(r):
        want, got = getattr(r, f.name), getattr(t, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(_np(got), _np(want), err_msg=f.name)
            assert got.shape == tuple(np.shape(want)), f.name
        else:
            assert got == want or f.name == "spec", f.name


def test_prepare_equals_reference(traces):
    for r, t in traces.values():
        assert_same_tensors(r, t)
        assert t.spec == default_spec()
        assert (t.num_line_words, t.sig_words, t.sig_bits, t.num_segments) == \
            (r.num_line_words, r.sig_words, r.sig_bits, r.num_segments)


def test_prepare_defaults_to_cuda(traces):
    rt = r_make_trace("pagerank", "arxiv", num_kernels=1)
    if torch.cuda.is_available():
        assert TP.prepare(_port_trace(rt)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TP.prepare(_port_trace(rt))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 6409])
def test_pack_unpack_popcount(n):
    bits = np.random.default_rng(n).random((2, n)) < 0.4
    bits[:, -1] = True
    want = np.stack([np.asarray(RP.pack_bitmap(jnp.asarray(b))) for b in bits])
    got = TP.pack_bitmap(torch.from_numpy(bits))
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(TP.unpack_bitmap(got, n).numpy(), bits)
    assert not TP.unpack_bitmap(got, got.shape[1] * 32)[:, n:].any()  # pad bits
    np.testing.assert_array_equal(
        TP.popcount_words(got).numpy(),
        [int(RP.popcount_words(jnp.asarray(w))) for w in want])


def test_scatter_set_sentinels_duplicates_and_range():
    n = 100
    ids = np.array([[5, 5, -1, 99, 100, 3, -7, 64, 5, 31],
                    [-1] * 10], dtype=np.int32)
    valid = ids >= 0
    valid[0, 3] = False  # a valid-looking id switched off
    base = np.zeros((2, 4), np.uint32)
    base[1, 0] = 0x80000001
    for v in (valid, None):
        want = np.stack([np.asarray(RP.scatter_set(
            jnp.asarray(base[i]), jnp.asarray(ids[i]),
            None if v is None else jnp.asarray(v[i]), n)) for i in range(2)])
        got = TP.scatter_set(torch.from_numpy(base.view(np.int32)),
                             torch.from_numpy(ids),
                             None if v is None else torch.from_numpy(v), n)
        np.testing.assert_array_equal(_np(got), want)
    # -1 is dropped, never wrapped into the last word
    got = TP.scatter_set(torch.zeros((1, 4), dtype=torch.int32),
                         torch.tensor([[-1, -1]], dtype=torch.int32), None, n)
    assert not got.any()


def test_gather_hits_equals_reference(traces):
    r, t = traces["components-arxiv"]
    rng = np.random.default_rng(3)
    bits = rng.random(r.num_lines) < 0.3
    rw = RP.pack_bitmap(jnp.asarray(bits))
    tw = TP.pack_bitmap(torch.from_numpy(bits))[None]
    for ids, valid in (("cpu_reads", "cpu_r_valid"), ("pim_writes", "pim_w_valid")):
        want = jax.vmap(lambda i, v: RP.gather_hits(rw, i, v))(
            getattr(r, ids), getattr(r, valid))
        got = TP.gather_hits(tw.expand(r.num_windows, -1), getattr(t, ids),
                             getattr(t, valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_line_sig_hits_equal_reference(traces):
    r, t = traces["components-arxiv"]
    r_sig = RP.sig_bits_from_ids(r, r.pim_reads[0], r.pim_r_valid[0])
    t_sig = TP.sig_bits_from_ids(t, t.pim_reads[:1], t.pim_r_valid[:1])[0]
    np.testing.assert_array_equal(_np(t_sig), np.asarray(r_sig))
    np.testing.assert_array_equal(TP.line_sig_hits(t, t_sig).numpy(),
                                  np.asarray(RP.line_sig_hits(r, r_sig)))


@pytest.mark.parametrize("n,w", [(6409, 0), (6409, 57), (200_000, 3)])
def test_line_window_u01_equals_reference(n, w):
    for mult, step in ((RP.KNUTH_MULT, RP.KNUTH_STEP), (RP.XXH_PRIME2, RP.XXH_PRIME5)):
        want = RP.line_window_u01(n, jnp.asarray(w), mult, step)
        got = TP.line_window_u01(n, w, int(mult), int(step), "cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cap", [10, 500, 100_000])
def test_evict_to_cap_equals_reference(cap):
    n = 6409
    rng = np.random.default_rng(cap)
    p = rng.random((3, n)) < np.array([0.01, 0.1, 0.6])[:, None]
    d = p & (rng.random((3, n)) < 0.5)
    rp = [RP.pack_bitmap(jnp.asarray(x)) for x in p]
    rd = [RP.pack_bitmap(jnp.asarray(x)) for x in d]
    tp, td = TP.pack_bitmap(torch.from_numpy(p)), TP.pack_bitmap(torch.from_numpy(d))
    got = TP.evict_to_cap(tp, td, 11, torch.full((3,), cap, dtype=torch.int32), n)
    for lane in range(3):
        want = RP.evict_to_cap(rp[lane], rd[lane], jnp.asarray(11), cap, n)
        np.testing.assert_array_equal(_np(got[0][lane]), np.asarray(want[0]))
        np.testing.assert_array_equal(_np(got[1][lane]), np.asarray(want[1]))
        assert float(got[2][lane]) == float(want[2])


@pytest.mark.parametrize("cacheable", [True, False])
def test_cpu_cache_step_equals_reference(traces, cacheable):
    r, t = traces["htap192"]
    hw_r = RHW(thread_cache_cap=40)  # small cap: the eviction path runs
    hw_t = stack_hw([THW(thread_cache_cap=40)], "cpu")
    st = stack_traces([t])
    rng = np.random.default_rng(9)
    bits = rng.random(r.num_lines) < 0.05
    pr, dr = RP.pack_bitmap(jnp.asarray(bits)), RP.pack_bitmap(jnp.asarray(bits[::-1]))
    pt = TP.pack_bitmap(torch.from_numpy(bits))[None]
    dt = TP.pack_bitmap(torch.from_numpy(bits[::-1].copy()))[None]
    for w in range(0, r.num_windows, 3):
        want = RP.cpu_cache_step(r, hw_r, pr, dr, jnp.asarray(w), cacheable=cacheable)
        got = TP.cpu_cache_step(st, hw_t, pt, dt, w, cacheable=cacheable)
        for f in ("present", "dirty"):
            np.testing.assert_array_equal(_np(getattr(got, f)[0]),
                                          np.asarray(getattr(want, f)), err_msg=f)
        for f in ("hits", "misses", "wb_lines", "mem_ns", "fill_bytes"):
            assert float(getattr(got, f)[0]) == float(getattr(want, f)), (w, f)
        pr, dr, pt, dt = want.present, want.dirty, got.present, got.dirty


def test_pad_trace_equals_reference(traces):
    r, t = traces["components-arxiv"]
    shape = dict(num_lines=16384, num_windows=r.num_windows + 5,
                 num_kernels=r.num_kernels + 2, pim_read_slots=300,
                 pim_write_slots=256, cpu_read_slots=70, cpu_write_slots=64)
    rp, tp = RP.pad_trace(r, **shape), TP.pad_trace(t, **shape)
    assert_same_tensors(rp, tp)
    assert (tp.pim_reads[:, 256:] == -1).all() and not tp.pim_r_valid[:, 256:].any()
    assert not tp.window_valid[r.num_windows:].any()
    with pytest.raises(ValueError, match="shrink"):
        TP.pad_trace(t, num_lines=10)
    with pytest.raises(ValueError, match="shrink"):
        TP.pad_trace(t, pim_read_slots=10)


def test_dummy_trace_equals_reference():
    shape = dict(num_lines=4096, num_windows=9, num_kernels=3,
                 pim_read_slots=256, pim_write_slots=256, cpu_read_slots=64,
                 cpu_write_slots=64)
    r = RP.dummy_trace(RP.default_spec(), **shape)
    t = TP.dummy_trace(default_spec(), **shape, device="cpu")
    assert_same_tensors(r, t)
    tt, hw, lazy = TP.dummy_lane_triple(default_spec(), shape,
                                        dict(partial_commits=False), device="cpu")
    assert tt.num_lines == 4096 and hw == THW() and lazy.partial_commits is False


def test_bucketing_equals_reference(traces):
    assert [TP.bucket_bound(n) for n in (1, 2, 5, 16, 17, 6409, 168335)] == \
        [RP.bucket_bound(n) for n in (1, 2, 5, 16, 17, 6409, 168335)]
    with pytest.raises(ValueError):
        TP.bucket_bound(0)
    pairs = list(traces.values()) * 2
    r_tts, t_tts = [p[0] for p in pairs], [p[1] for p in pairs]
    assert TP.bucket_shapes(t_tts) == RP.bucket_shapes(r_tts)
    for (ri, rb), (ti, tb) in zip(RP.bucket_traces(r_tts), TP.bucket_traces(t_tts)):
        assert ri == ti
        for a, b in zip(rb, tb):
            assert_same_tensors(a, b)


def test_neutral_trace_strips_presentation_metadata(traces):
    _, t = traces["htap192"]
    n = TP.neutral_trace(t)
    assert (n.name, n.threads) == ("", 0) and n.line_pos is t.line_pos
    assert TP.neutral_trace(n) is n
