"""The port's seed reference path on the CPU: every ``*_bool`` primitive of
repro_torch.sim.prep against repro.sim.prep's (and against the port's
packed twin), the seed loops against the vectorized counts, and
repro_torch.core._boolref against repro.core._boolref and the port's
packed engine — every SimResult field, exactly, on the fixtures of
tests/test_packed_engine.py.  Bitmaps, images and counts are integers and
the float accumulators see the same float32 operations in the same order,
so the tolerance everywhere is exact equality."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import _boolref as RB
from repro.core.coherence import LazyPIMConfig as RLazy
from repro.sim import prep as RP
from repro.sim.costmodel import HWParams as RHW
from repro.sim.trace import make_graph_trace, make_htap_trace
from repro_torch.core import _boolref as TB
from repro_torch.core.coherence import LazyPIMConfig as TLazy
from repro_torch.sim import prep as TP
from repro_torch.sim.costmodel import HWParams as THW
from repro_torch.sim.engine import run_all, stack_hw, stack_traces
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


def _pair(rt):
    fields = {f.name: np.asarray(getattr(rt, f.name)) for f in dataclasses.fields(rt)}
    return RP.prepare(rt), TP.prepare(trace_from_numpy(fields, "cpu"), device="cpu")


@pytest.fixture(scope="module")
def pairs():
    """(reference, port) prepared traces: the two fixtures of
    tests/test_packed_engine.py."""
    return {
        "tt": _pair(make_graph_trace("components", "arxiv", threads=16,
                                     num_kernels=3, windows_per_kernel=2,
                                     scale=0.4)),
        "tt_htap": _pair(make_htap_trace("htap128", threads=16, num_kernels=3,
                                         windows_per_kernel=2, scale=0.004)),
    }


def _bitmaps(n, lanes, seed, p=0.02):
    return np.random.default_rng(seed).random((lanes, n)) < p


def _images(pairs, key, lanes=3):
    """(lanes, sig_bits) bool read images of the first windows' PIM reads,
    built by the reference; and the same windows' packed images."""
    r, t = pairs[key]
    imgs = np.stack([np.asarray(RP.sig_bits_from_ids_bool(r, r.pim_reads[w],
                                                          r.pim_r_valid[w]))
                     for w in range(lanes)])
    return imgs, TP.pack_bitmap(torch.from_numpy(imgs))


@pytest.mark.parametrize("key", ["tt", "tt_htap"])
@pytest.mark.parametrize("field", ["pim_reads", "pim_writes", "cpu_writes"])
def test_sig_bits_from_ids_bool(pairs, key, field):
    r, t = pairs[key]
    valid = {"pim_reads": "pim_r_valid", "pim_writes": "pim_w_valid",
             "cpu_writes": "cpu_w_valid"}[field]
    want = jax.vmap(lambda i, v: RP.sig_bits_from_ids_bool(r, i, v))(
        getattr(r, field), getattr(r, valid))
    got = TP.sig_bits_from_ids_bool(t, getattr(t, field), getattr(t, valid))
    assert got.dtype == torch.bool and got.shape == (t.num_windows, t.sig_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    packed = TP.sig_bits_from_ids(t, getattr(t, field), getattr(t, valid))
    assert torch.equal(got, TP.unpack_bitmap(packed, t.sig_bits))


@pytest.mark.parametrize("key", ["tt", "tt_htap"])
def test_sig_and_bank_bits_from_bitmap_bool(pairs, key):
    r, t = pairs[key]
    bms = _bitmaps(t.num_lines, 3, 1)
    bmt = torch.from_numpy(bms)
    words = TP.pack_bitmap(bmt)
    got = TP.sig_bits_from_bitmap_bool(t, bmt)
    bank = TP.bank_bits_from_bitmap_bool(t, bmt)
    assert bank.shape == (3, TP.CPUWS_REGS, t.sig_bits)
    for lane in range(3):
        bm = jnp.asarray(bms[lane])
        np.testing.assert_array_equal(got[lane].numpy(),
                                      np.asarray(RP.sig_bits_from_bitmap_bool(r, bm)))
        np.testing.assert_array_equal(bank[lane].numpy(),
                                      np.asarray(RP.bank_bits_from_bitmap_bool(r, bm)))
    assert torch.equal(got, TP.unpack_bitmap(TP.sig_bits_from_bitmap(t, words),
                                             t.sig_bits))
    assert torch.equal(bank, TP.unpack_bitmap(TP.bank_bits_from_bitmap(t, words),
                                              t.sig_bits))
    # an empty bitmap inserts nothing
    empty = torch.zeros((1, t.num_lines), dtype=torch.bool)
    assert not TP.sig_bits_from_bitmap_bool(t, empty).any()
    assert not TP.bank_bits_from_bitmap_bool(t, empty).any()


@pytest.mark.parametrize("key", ["tt", "tt_htap"])
@pytest.mark.parametrize("density", [0.002, 0.05, 0.5])
def test_conflict_any_bool(pairs, key, density):
    r, t = pairs[key]
    imgs, img_words = _images(pairs, key)
    bms = _bitmaps(t.num_lines, 3, 2, density)
    bank = TP.bank_bits_from_bitmap_bool(t, torch.from_numpy(bms))
    got = TP.conflict_any_bool(t, torch.from_numpy(imgs), bank)
    want = [bool(RP.conflict_any_bool(r, jnp.asarray(imgs[i]), jnp.asarray(bank[i].numpy())))
            for i in range(3)]
    assert got.tolist() == want
    packed = TP.conflict_any(t, img_words, TP.pack_bitmap(bank))
    assert torch.equal(got, packed)


@pytest.mark.parametrize("key", ["tt", "tt_htap"])
def test_members_and_ids_member_bool(pairs, key):
    r, t = pairs[key]
    imgs, img_words = _images(pairs, key)
    bms = _bitmaps(t.num_lines, 3, 3, 0.3)
    got = TP.members_bool(t, torch.from_numpy(bms), torch.from_numpy(imgs))
    packed = TP.members(t, TP.pack_bitmap(torch.from_numpy(bms)), img_words)
    assert torch.equal(got, TP.unpack_bitmap(packed, t.num_lines))
    ids, valid = t.pim_writes[:3], t.pim_w_valid[:3]
    got_ids = TP.ids_member_bool(t, ids, valid, torch.from_numpy(imgs))
    hits = torch.stack([TP.line_sig_hits(t, img_words[i]).all(1) for i in range(3)])
    assert torch.equal(got_ids, valid & hits.gather(1, ids.clamp(0, t.num_lines - 1)
                                                       .to(torch.int64)))
    for lane in range(3):
        img = jnp.asarray(imgs[lane])
        np.testing.assert_array_equal(
            got[lane].numpy(), np.asarray(RP.members_bool(r, jnp.asarray(bms[lane]), img)))
        np.testing.assert_array_equal(
            got_ids[lane].numpy(),
            np.asarray(RP.ids_member_bool(r, r.pim_writes[lane], r.pim_w_valid[lane], img)))
        np.testing.assert_array_equal(
            got_ids[lane].numpy(),
            np.asarray(RP.ids_member(r, r.pim_writes[lane], r.pim_w_valid[lane],
                                     RP.pack_bitmap(img))))
    assert 0 < int(got.sum()) < int(torch.from_numpy(bms).sum())  # real false positives


@pytest.mark.parametrize("key", ["tt", "tt_htap"])
def test_scatter_set_and_gather_hits_bool(pairs, key):
    r, t = pairs[key]
    n = t.num_lines
    bms = _bitmaps(n, t.num_windows, 4)
    base = torch.from_numpy(bms)
    got = TP.scatter_set_bool(base, t.cpu_writes, t.cpu_w_valid)
    hits = TP.gather_hits_bool(got, t.pim_reads, t.pim_r_valid)
    words = TP.pack_bitmap(base)
    assert torch.equal(got, TP.unpack_bitmap(
        TP.scatter_set(words, t.cpu_writes, t.cpu_w_valid, n), n))
    assert torch.equal(hits, TP.gather_hits(TP.pack_bitmap(got), t.pim_reads,
                                            t.pim_r_valid))
    assert torch.equal(base, torch.from_numpy(bms))  # the input is not written
    for w in range(t.num_windows):
        want = RP.scatter_set_bool(jnp.asarray(bms[w]), r.cpu_writes[w], r.cpu_w_valid[w])
        np.testing.assert_array_equal(got[w].numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            hits[w].numpy(),
            np.asarray(RP.gather_hits_bool(want, r.pim_reads[w], r.pim_r_valid[w])))


@pytest.mark.parametrize("cap", [10, 500, 100_000])
def test_evict_to_cap_bool(cap):
    n = 6409
    rng = np.random.default_rng(cap)
    p = rng.random((3, n)) < np.array([0.01, 0.1, 0.6])[:, None]
    d = p & (rng.random((3, n)) < 0.5)
    capt = torch.full((3,), cap, dtype=torch.int32)
    got = TP.evict_to_cap_bool(torch.from_numpy(p), torch.from_numpy(d), 11, capt)
    packed = TP.evict_to_cap(TP.pack_bitmap(torch.from_numpy(p)),
                             TP.pack_bitmap(torch.from_numpy(d)), 11, capt, n)
    assert torch.equal(TP.pack_bitmap(got[0]), packed[0])
    assert torch.equal(TP.pack_bitmap(got[1]), packed[1])
    assert torch.equal(got[2], packed[2])
    for lane in range(3):
        want = RP.evict_to_cap_bool(jnp.asarray(p[lane]), jnp.asarray(d[lane]),
                                    jnp.asarray(11), cap)
        np.testing.assert_array_equal(got[0][lane].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1][lane].numpy(), np.asarray(want[1]))
        assert float(got[2][lane]) == float(want[2])


@pytest.mark.parametrize("cacheable", [True, False])
def test_cpu_cache_step_bool(pairs, cacheable):
    r, t = pairs["tt_htap"]
    hw_r = RHW(thread_cache_cap=40)  # small cap: the eviction path runs
    hw_t = stack_hw([THW(thread_cache_cap=40)], "cpu")
    st = stack_traces([t])
    bits = np.random.default_rng(9).random(r.num_lines) < 0.05
    pr, dr = jnp.asarray(bits), jnp.asarray(bits[::-1])
    pt = torch.from_numpy(bits)[None]
    dt = torch.from_numpy(bits[::-1].copy())[None]
    pk, dk = TP.pack_bitmap(pt), TP.pack_bitmap(dt)
    for w in range(r.num_windows):
        want = RP.cpu_cache_step_bool(r, hw_r, pr, dr, jnp.asarray(w), cacheable=cacheable)
        got = TP.cpu_cache_step_bool(st, hw_t, pt, dt, w, cacheable=cacheable)
        twin = TP.cpu_cache_step(st, hw_t, pk, dk, w, cacheable=cacheable)
        for f in ("present", "dirty"):
            np.testing.assert_array_equal(getattr(got, f)[0].numpy(),
                                          np.asarray(getattr(want, f)), err_msg=f)
            assert torch.equal(TP.pack_bitmap(getattr(got, f)), getattr(twin, f)), f
        for f in ("hits", "misses", "wb_lines", "mem_ns", "fill_bytes"):
            assert float(getattr(got, f)[0]) == float(getattr(want, f)), (w, f)
            assert torch.equal(getattr(got, f), getattr(twin, f)), (w, f)
        pr, dr, pt, dt, pk, dk = (want.present, want.dirty, got.present, got.dirty,
                                  twin.present, twin.dirty)


def test_seed_loops_equal_vectorized_counts():
    rng = np.random.default_rng(5)
    a = rng.integers(-1, 40, size=(50, 17)).astype(np.int32)
    b = rng.integers(-1, 40, size=(50, 9)).astype(np.int32)
    a[3] = -1  # an empty row
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    loop = TP._uniq_count_loop(ta)
    assert loop.dtype == torch.float32
    assert torch.equal(loop, TP._uniq_count(ta))
    np.testing.assert_array_equal(loop.numpy(), RP._uniq_count_loop(a))
    union = TP._uniq_union_count_loop(ta, tb)
    assert torch.equal(union, TP._uniq_count(torch.cat([ta, tb], 1)))
    np.testing.assert_array_equal(union.numpy(), RP._uniq_union_count_loop(a, b))


# ---------------------------------------------------------------------------
# Whole seed engine: every field of every mechanism
# ---------------------------------------------------------------------------


def _assert_results_equal(a, b, label):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys(), label
    for k in da:
        assert da[k] == db[k], f"{label}: field {k}: {da[k]} != {db[k]}"


@pytest.mark.parametrize("key", ["tt", "tt_htap"])
def test_run_all_bool_equals_reference_and_packed(pairs, key):
    r, t = pairs[key]
    got = TB.run_all_bool(t)
    assert list(got) == ["cpu", "fg", "cg", "nc", "lazypim", "ideal"]
    want = RB.run_all_bool(r, RHW())
    packed = run_all(t, THW(), device="cpu")
    for m in got:
        _assert_results_equal(got[m], want[m], f"{t.name}/{m} vs repro")
        _assert_results_equal(got[m], packed[m], f"{t.name}/{m} vs packed")
    assert got["lazypim"].commits > 0 and got["cg"].flush_lines > 0


@pytest.mark.parametrize("key,cfg", [
    ("tt", dict(partial_commits=False)),
    ("tt_htap", dict(partial_commits=False)),
    ("tt", dict(use_dbi=False)),
], ids=["tt-full_commit", "tt_htap-full_commit", "tt-no_dbi"])
def test_lazypim_ablations_equal_reference_and_packed(pairs, key, cfg):
    r, t = pairs[key]
    got = TB.simulate_lazypim_bool(t, THW(), TLazy(**cfg))
    _assert_results_equal(got, RB.simulate_lazypim_bool(r, RHW(), RLazy(**cfg)),
                          f"{t.name}/lazypim {cfg} vs repro")
    packed = run_all(t, THW(), ("lazypim",), TLazy(**cfg), device="cpu")["lazypim"]
    _assert_results_equal(got, packed, f"{t.name}/lazypim {cfg} vs packed")


def test_single_mechanism_entry_points_and_checks(pairs):
    r, t = pairs["tt"]
    hw = THW()
    sims = {"cpu": TB.simulate_cpu_only_bool, "ideal": TB.simulate_ideal_bool,
            "fg": TB.simulate_fg_bool, "cg": TB.simulate_cg_bool,
            "nc": TB.simulate_nc_bool}
    assert set(sims) == set(TB.ACC_FNS_BOOL)
    all_bool = TB.run_all_bool(t, hw, mechanisms=tuple(sims))
    for m, fn in sims.items():
        assert fn(t, hw) == all_bool[m]
    with pytest.raises(NotImplementedError, match="cpuws_regs"):
        TB.simulate_lazypim_bool(t, hw, TLazy(cpuws_regs=8))
