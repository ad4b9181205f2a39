"""Trace invariants of repro_torch over every synthesized family, mirroring
``tests/test_trace_props.py`` (seeded draws through ``hypothesis`` or the
repo's shim, ``tests/_fallback_hypothesis.py``), on the CPU:

* every access slot is the -1 sentinel or a line id inside the region, and
  a window inserts at most ``MAX_SIG_ADDRS`` distinct lines a set (§5.4);
* pre-writes are boolean rows over the region, one non-empty row a kernel;
  the kernel structure is consistent; a fixed seed regenerates the trace;
* ``prepare()`` round trip: packed pre-writes unpack to the bitmaps with
  zero pad bits, the validity masks mirror the sentinels, the unique-line
  counts equal a direct recount;
* ``pad_trace``: padded lines set no bitmap or Bloom bit, padded slots are
  invalid sentinels, padded windows leave the CG and LazyPIM accumulators
  unchanged; bucketing is deterministic; the §5.4 cap holds on the densest
  full-scale family.

The draws cover the two paper families and the four extended apps;
``tests/test_torch_synth_extended.py`` holds the same traces to repro's."""

from __future__ import annotations

import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _fallback_hypothesis import given, settings, st

import pytest

from repro_torch.core.coherence import LazyPIMConfig
from repro_torch.core.signatures import unpack_words
from repro_torch.sim import prep as P
from repro_torch.sim.costmodel import HWParams
from repro_torch.sim.engine import _sweep_accs, stack_hw, stack_lazy, stack_traces
from repro_torch.sim.trace import MAX_SIG_ADDRS, make_trace

CPU = "cpu"
HW = HWParams()

# One representative per family: seed graph, seed HTAP, frontier (both
# apps), streaming ingest, the two-tenant mix.
FAMILY_CASES = (
    ("components", "arxiv"),
    ("htap192", None),
    ("bfs", "arxiv"),
    ("sssp", "gnutella"),
    ("htap_stream", None),
    ("mtmix", "arxiv"),
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _small_trace(case_idx: int, seed: int, threads: int, backend: str = "torch"):
    app, graph = FAMILY_CASES[case_idx % len(FAMILY_CASES)]
    kw = dict(threads=threads, seed=seed, num_kernels=3, windows_per_kernel=2,
              scale=0.25 if graph is not None else 0.004, device=CPU, backend=backend)
    return make_trace(app, graph, **kw)


@settings(max_examples=12, deadline=None)
@given(case=st.integers(0, len(FAMILY_CASES) - 1),
       seed=st.integers(0, 2 ** 16),
       tsel=st.integers(0, 1))
def test_trace_invariants(case, seed, tsel):
    threads = (4, 16)[tsel]
    tr = _small_trace(case, seed, threads)
    n = tr.num_lines

    for name in ("pim_reads", "pim_writes", "cpu_reads", "cpu_writes"):
        ids = getattr(tr, name)
        assert ids.dtype == torch.int32, name
        assert bool(((ids == -1) | ((ids >= 0) & (ids < n))).all()), \
            f"{tr.name}.{name}: slot outside [-1] and [0, {n})"

    for name in ("pim_reads", "pim_writes"):
        assert float(P._uniq_count(getattr(tr, name)).max()) <= MAX_SIG_ADDRS, name

    pre = tr.pre_writes
    assert pre.shape == (tr.num_kernels, n) and pre.dtype == torch.bool
    assert bool(pre.any(1).all()), "a kernel with an empty inter-kernel phase"

    kid = tr.kernel_id
    assert int(kid.min()) == 0 and int(kid.max()) == tr.num_kernels - 1
    assert int(tr.kernel_start.sum()) == int(tr.kernel_end.sum()) == tr.num_kernels

    # a fixed seed regenerates the trace, on either backend
    for backend in ("torch", "ref"):
        again = _small_trace(case, seed, threads, backend)
        for name in ("pim_reads", "cpu_writes", "pre_writes", "cpu_instr"):
            assert torch.equal(getattr(tr, name), getattr(again, name)), (backend, name)


@settings(max_examples=6, deadline=None)
@given(case=st.integers(0, len(FAMILY_CASES) - 1),
       seed=st.integers(0, 2 ** 16))
def test_prepare_round_trip(case, seed):
    """prepare() stages the trace without altering it: packed words unpack
    back to the boolean bitmaps, the validity masks mirror the -1
    sentinels, and the unique-line counts equal a direct recount."""
    tr = _small_trace(case, seed, 16)
    tt = P.prepare(tr, device=CPU)
    n = tr.num_lines

    assert torch.equal(unpack_words(tt.pre_writes_words, n), tr.pre_writes)
    pad = tt.num_line_words * 32 - n
    if pad:
        last = tt.pre_writes_words[:, -1].to(torch.int64) & 0xFFFFFFFF
        assert not bool((last >> (32 - pad)).any()), "pre-writes leak into the pad bits"

    for ids_name, valid_name in (("pim_reads", "pim_r_valid"),
                                 ("pim_writes", "pim_w_valid"),
                                 ("cpu_reads", "cpu_r_valid"),
                                 ("cpu_writes", "cpu_w_valid")):
        ids = getattr(tr, ids_name)
        assert torch.equal(getattr(tt, ids_name), ids)
        assert torch.equal(getattr(tt, valid_name), ids >= 0)

    pr, pw = tr.pim_reads, tr.pim_writes
    assert torch.equal(tt.pim_uniq_r, P._uniq_count_loop(pr))
    assert torch.equal(tt.pim_uniq_w, P._uniq_count_loop(pw))
    assert torch.equal(tt.pim_uniq, P._uniq_union_count_loop(pr, pw))


def _accs(tt):
    """CG and LazyPIM accumulators of one trace (the window loops' raw
    sums)."""
    acc = _sweep_accs(stack_traces([P.neutral_trace(tt)]), stack_hw([HW], CPU),
                      ("cg", "lazypim"), stack_lazy([LazyPIMConfig()], CPU))
    return {m: {k: float(v[0]) for k, v in a.items()} for m, a in acc.items()}


@settings(max_examples=6, deadline=None)
@given(case=st.integers(0, len(FAMILY_CASES) - 1),
       seed=st.integers(0, 2 ** 16))
def test_padding_invariants(case, seed):
    """pad_trace: padded lines never set a bitmap or Bloom bit (images over
    the padded geometry equal the unpadded ones), padded slots are invalid
    sentinels, and padded windows leave every accumulator unchanged."""
    tr = _small_trace(case, seed, 16)
    tt = P.prepare(tr, device=CPU)
    n, w, k = tt.num_lines, tt.num_windows, tt.num_kernels
    bw = tr.cpu_writes.shape[1]
    pt = P.pad_trace(tt, num_lines=P.bucket_bound(n), num_windows=w + 4,
                     num_kernels=k + 1, cpu_write_slots=bw + 8)
    n2 = pt.num_lines

    assert bool((pt.cpu_writes[:, bw:] == -1).all())
    assert not bool(pt.cpu_w_valid[:, bw:].any())
    assert not bool(pt.window_valid[w:].any()) and bool(pt.window_valid[:w].all())

    for widx in (0, w - 1, w):  # two real windows and a padded one
        words = P.scatter_set(torch.zeros((pt.num_line_words,), dtype=torch.int32),
                              pt.pim_reads[widx], pt.pim_r_valid[widx], n2)
        assert not bool(unpack_words(words, n2)[n:].any()), "a padded line entered a bitmap"
        if widx < w:
            img_p = P.sig_bits_from_ids(pt, pt.pim_reads[widx:widx + 1],
                                        pt.pim_r_valid[widx:widx + 1])
            img_u = P.sig_bits_from_ids(tt, tt.pim_reads[widx:widx + 1],
                                        tt.pim_r_valid[widx:widx + 1])
            assert torch.equal(img_p, img_u)
        else:
            assert int(P.popcount_words(words)) == 0, "a padded window had accesses"

    pw = unpack_words(pt.pre_writes_words, n2)
    assert not bool(pw[:, n:].any()) and not bool(pw[k:].any())
    assert _accs(tt) == _accs(pt)


def test_bucketing_is_deterministic():
    tts = [P.prepare(_small_trace(i, seed=3, threads=16), device=CPU)
           for i in (0, 1, 2, 5, 0)]
    a, b = P.bucket_traces(tts), P.bucket_traces(tts)
    assert [idx for idx, _ in a] == [idx for idx, _ in b]
    for (_, pa), (_, pb) in zip(a, b):
        for x, y in zip(pa, pb):
            assert (x.num_lines, x.num_windows, x.num_kernels) == \
                (y.num_lines, y.num_windows, y.num_kernels)
            assert torch.equal(x.pim_reads, y.pim_reads)
    for idx, padded in a:
        assert padded[0].num_lines == P.bucket_bound(padded[0].num_lines)
        for i, p in zip(idx, padded):
            assert p.num_lines >= tts[i].num_lines


@pytest.mark.parametrize("app,graph", [("bfs", "enron"), ("sssp", "enron")])
def test_max_sig_addrs_is_enforced_at_full_scale(app, graph):
    """The §5.4 cap holds at full scale on the frontier family, whose peak
    windows are the widest read sets generated."""
    tr = make_trace(app, graph, threads=16, device=CPU)
    uniq = P._uniq_count(tr.pim_reads)
    assert float(uniq.max()) <= MAX_SIG_ADDRS
    assert float(uniq.max()) > 4 * float(uniq.min())  # the windows are bursty


def test_extended_fleet_fits_the_paper_buckets():
    """The 22 workloads need the paper fleet's three line buckets (16,384,
    65,536, 262,144); mtmix-enron's 84,944 lines join the largest."""
    from repro_torch.sim.trace import all_workloads

    lines = {f"{a}-{g}" if g else a: make_trace(a, g, num_kernels=2, device=CPU).num_lines
             for a, g in all_workloads(extended=True)}
    assert {P.bucket_bound(n) for n in lines.values()} == {16_384, 65_536, 262_144}
    assert lines["mtmix-enron"] == 84_944
    assert P.bucket_bound(lines["mtmix-enron"]) == 262_144
