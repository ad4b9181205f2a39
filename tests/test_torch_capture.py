"""The port's capture layer (repro_torch.capture) held against repro.capture
on the CPU: the line-mapper, the windower, the counter-PRNG streams, the
``capture/lazy_embed`` and ``capture/kv_serve`` traces field by field (at
the tiny scale of ``tests/test_capture.py`` and at the default scale), the
hand-computed KV decode transcript of ``tests/test_capture.py``, and the
captured studies through ``Study`` on both engines, all exact.  Also the
naming ``ValueError``s of unknown capture specs (``capture/moe_experts``
has its own file, ``tests/test_torch_moe_capture.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.capture import layout as r_layout
from repro.capture import recorder as r_recorder
from repro.capture import streams as r_streams
from repro.sim.trace import make_trace as r_make_trace
from repro_torch.capture import WindowRecorder, capture_trace
from repro_torch.capture.layout import LineLayout
from repro_torch.capture.lazy_embed import LazyEmbedConfig, row_lines
from repro_torch.capture.recorder import split_step, subsample_even
from repro_torch.capture.streams import Stream, perm
from repro_torch.sim.prep import bucket_bound
from repro_torch.sim.synth import MAX_SIG_ADDRS
from repro_torch.sim.trace import build_plan, make_trace

APP = "capture/lazy_embed"
TINY = dict(num_kernels=3, windows_per_kernel=2, scale=0.05)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _assert_same_trace(r, t):
    for f in dataclasses.fields(r):
        a, b = getattr(r, f.name), getattr(t, f.name)
        if isinstance(b, torch.Tensor):
            assert b.device.type == "cpu", f.name
            b = b.numpy()
            a = np.asarray(a)
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert a == b, f.name


# ---------------------------------------------------------------------------
# Line-mapper, windower, streams
# ---------------------------------------------------------------------------


def test_layout_pads_to_pow4_bucket():
    lay = LineLayout.build([("a", 100), ("b", 30)])
    assert lay.natural_lines == 130
    assert lay.num_lines == bucket_bound(130) == 256
    assert lay.region("b").base == 100
    with pytest.raises(ValueError, match="out of"):
        lay.region("a").line(100)
    with pytest.raises(KeyError):
        lay.region("c")
    with pytest.raises(ValueError, match="duplicate"):
        LineLayout.build([("a", 1), ("a", 2)])
    with pytest.raises(ValueError, match=">= 1 line"):
        LineLayout.build([("a", 0)])
    ref = r_layout.LineLayout.build([("a", 100), ("b", 30)])
    assert lay.num_lines == ref.num_lines
    assert [dataclasses.astuple(r) for r in lay.regions] == \
        [dataclasses.astuple(r) for r in ref.regions]
    np.testing.assert_array_equal(lay.region("b").line(np.arange(30)),
                                  ref.region("b").line(np.arange(30)))


@pytest.mark.parametrize("vocab", [64, 1200, 24000])
def test_row_lines_match_reference(vocab):
    from repro.capture.lazy_embed import LazyEmbedConfig as RCfg
    from repro.capture.lazy_embed import row_lines as r_row_lines

    cfg, rcfg = LazyEmbedConfig(vocab=vocab), RCfg(vocab=vocab)
    rows = np.random.default_rng(vocab).integers(0, vocab, size=(3, 17))
    assert cfg.layout().num_lines == rcfg.layout().num_lines
    np.testing.assert_array_equal(row_lines(cfg.layout(), rows),
                                  r_row_lines(rcfg.layout(), rows))
    for scale in (0.05, 0.5, 1.0, 2.0):
        assert dataclasses.astuple(LazyEmbedConfig.scaled(scale)) == \
            dataclasses.astuple(RCfg.scaled(scale))


def test_split_step_insert_cap():
    ids = np.arange(2 * MAX_SIG_ADDRS + 10)
    subs = split_step(ids, ids[:5], None, None)
    assert len(subs) == 3
    np.testing.assert_array_equal(np.concatenate([s[0] for s in subs]), ids)
    for pr, pw, cr, cw in subs:
        assert len(pr) <= MAX_SIG_ADDRS and len(pw) <= MAX_SIG_ADDRS
        assert len(cr) == 0 and len(cw) == 0
    assert len(split_step(ids[:10], ids[:10], ids[:3], None)) == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_step_matches_reference(seed):
    rng = np.random.default_rng(seed)
    streams = [rng.integers(0, 10_000, size=rng.integers(0, 900))
               for _ in range(4)]
    got = split_step(*streams)
    want = r_recorder.split_step(*streams)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_subsample_even():
    ids = np.arange(1000)
    out = subsample_even(ids, 64)
    assert len(out) == 64 and out[0] == 0
    assert np.all(np.diff(out) > 0)
    np.testing.assert_array_equal(subsample_even(ids[:10], 64), ids[:10])
    for n in (65, 333, 1000):
        np.testing.assert_array_equal(subsample_even(ids[:n], 64),
                                      r_recorder.subsample_even(ids[:n], 64))


def test_recorder_rejects_bad_geometry_and_empty_phases():
    with pytest.raises(AssertionError, match="bucket_bound"):
        WindowRecorder("x", 1000, 16, 6.0)
    rec = WindowRecorder("x", 1024, 16, 6.0)
    with pytest.raises(AssertionError, match="empty"):
        rec.begin_kernel([])
    with pytest.raises(AssertionError, match="before begin_kernel"):
        rec.step(pim_reads=[1])
    rec.begin_kernel([5])
    with pytest.raises(AssertionError, match="out of"):
        rec.step(pim_reads=[1024])


def test_recorder_emits_the_reference_trace():
    """A hand-driven recording gives the same WindowTrace in both packages."""
    rng = np.random.default_rng(3)
    recs = [WindowRecorder("x", 4096, 8, 5.0), r_recorder.WindowRecorder("x", 4096, 8, 5.0)]
    for k in range(3):
        pre = rng.integers(0, 4096, size=20)
        steps = [[rng.integers(0, 4096, size=rng.integers(1, 600)) for _ in range(4)]
                 for _ in range(2)]
        for rec in recs:
            rec.begin_kernel(pre)
            for pr, pw, cr, cw in steps:
                rec.step(pr, pw, cr, cw, pim_instr=10.0, cpu_instr=3.0, cpu_priv=1.0)
    _assert_same_trace(recs[1].finish(), recs[0].finish("cpu"))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name", ["touch", "reader", "group_shift"])
def test_streams_match_reference(seed, name):
    t, r = Stream(APP, seed, name), r_streams.Stream(APP, seed, name)
    assert tuple(int(k) for k in t.key) == tuple(int(k) for k in r.key)
    for _ in range(3):
        np.testing.assert_array_equal(t.zipf(24000, 3.0, 48), r.zipf(24000, 3.0, 48))
        assert t.zipf(500, 1.5) == r.zipf(500, 1.5)
        np.testing.assert_array_equal(t.mod(375, 4), r.mod(375, 4))
        assert t.mod(17) == r.mod(17)
        np.testing.assert_array_equal(t.u01(9), r.u01(9))
        assert t.u01() == r.u01()
    np.testing.assert_array_equal(perm(APP, seed, name, 3000),
                                  r_streams.perm(APP, seed, name, 3000))


# ---------------------------------------------------------------------------
# capture/lazy_embed against repro
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(seed=1, **TINY), dict()], ids=["tiny", "default"])
def test_capture_lazy_embed_matches_reference(kw):
    t = make_trace(APP, device="cpu", **kw)
    _assert_same_trace(r_make_trace(APP, **kw), t)
    assert t.name == APP and t.num_lines == bucket_bound(t.num_lines)
    pre = t.pre_writes.numpy()
    assert pre.dtype == bool and pre.any(axis=1).all()
    if not kw:
        # the default scale: 48,000 lines in the 65,536-line bucket; 72
        # steps of 4 x 48 touched rows (384 lines, over the 250-insert
        # cap), so two windows a step
        assert (t.num_lines, t.num_windows, t.num_kernels) == (65_536, 144, 24)


def test_capture_determinism():
    a = make_trace(APP, seed=1, device="cpu", **TINY)
    b = make_trace(APP, seed=1, device="cpu", **TINY)
    c = make_trace(APP, seed=2, device="cpu", **TINY)
    _assert_same_trace(a, b)
    assert not torch.equal(a.pim_reads, c.pim_reads)


def test_capture_trace_entry_point():
    t = capture_trace(APP, seed=1, cpu_reuse=9.0, device="cpu", **TINY)
    assert t.cpu_reuse == 9.0
    _assert_same_trace(r_make_trace(APP, seed=1, cpu_reuse=9.0, **TINY), t)


@pytest.mark.parametrize("engine", ["batch", "sequential"])
def test_study_matches_reference(engine):
    from repro.api import Study as RStudy
    from repro_torch.api import Study

    got = Study([APP], device="cpu").run(engine=engine)
    want = RStudy([APP]).run(engine=engine)
    assert [p.workload for p in got] == [p.workload for p in want] == [APP]
    for a, b in zip(got.points, want.points):
        assert set(a.results) == set(b.results)
        for m in b.results:
            assert dataclasses.asdict(a.results[m]) == dataclasses.asdict(b.results[m]), m


def test_naming_valueerrors():
    with pytest.raises(ValueError, match="unknown capture spec"):
        make_trace("capture/bogus", device="cpu")
    with pytest.raises(ValueError, match="unknown capture spec"):
        capture_trace("capture/bogus", device="cpu")
    with pytest.raises(ValueError, match="graph_name must be None"):
        make_trace(APP, "enron", device="cpu")
    with pytest.raises(ValueError, match="recorded from live"):
        build_plan(APP)
    from repro_torch.api import Study

    with pytest.raises(ValueError, match="workloads\\[0\\].*unknown capture spec"):
        Study(["capture/bogus"], device="cpu")


def test_capture_defaults_to_cuda():
    if torch.cuda.is_available():
        assert make_trace(APP, **TINY).pim_reads.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_trace(APP, **TINY)


# ---------------------------------------------------------------------------
# capture/kv_serve against repro
# ---------------------------------------------------------------------------

KV_APP = "capture/kv_serve"


@pytest.mark.parametrize("kw", [dict(seed=1, **TINY), dict()], ids=["tiny", "default"])
def test_capture_kv_serve_matches_reference(kw):
    t = make_trace(KV_APP, device="cpu", **kw)
    _assert_same_trace(r_make_trace(KV_APP, **kw), t)
    assert t.name == KV_APP and t.num_lines == bucket_bound(t.num_lines)
    assert t.cpu_reuse == 8.0
    if not kw:
        # the default scale: 500 pages x 128 lines + 63 page-table lines
        # in the 65,536-line bucket; 24 kernels x 3 decode steps
        assert (t.num_lines, t.num_kernels) == (65_536, 24)


@pytest.mark.parametrize("scale", [0.05, 0.5, 1.0, 2.0])
def test_kv_serve_config_and_helpers_match_reference(scale):
    from repro.capture import kv_serve as R
    from repro_torch.capture import kv_serve as K

    cfg, rcfg = K.KVServeConfig.scaled(scale), R.KVServeConfig.scaled(scale)
    assert dataclasses.astuple(cfg) == dataclasses.astuple(rcfg)
    assert cfg.pages_per_req == rcfg.pages_per_req
    lay, rlay = cfg.layout(), rcfg.layout()
    assert lay.num_lines == rlay.num_lines
    rng = np.random.default_rng(int(scale * 100))
    for _ in range(20):
        page = int(rng.integers(0, cfg.num_pages))
        slot = int(rng.integers(0, K.PAGE_TOKENS))
        np.testing.assert_array_equal(K.token_lines(lay, page, slot),
                                      R.token_lines(rlay, page, slot))
        assert K.pt_line(lay, page) == R.pt_line(rlay, page)
    pages = [int(p) for p in rng.choice(cfg.num_pages, size=4, replace=False)]
    for pos in (1, 15, 16, 17, 63):
        assert K.decode_lines(lay, pages, pos) == R.decode_lines(rlay, pages, pos)
    assert (K.PAGE_TOKENS, K.LINES_PER_TOKEN, K.LINES_PER_PAGE, K.PT_ENTRIES_PER_LINE) == \
        (R.PAGE_TOKENS, R.LINES_PER_TOKEN, R.LINES_PER_PAGE, R.PT_ENTRIES_PER_LINE)


def test_kv_differential_hand_transcript():
    """The hand-computed decode transcript of ``tests/test_capture.py``,
    replayed against the port: 8 pages (page 0 the shared prefix), batch 2,
    2-token prompts, nobody finishing; ``pages`` at line 0, the one
    page-table line at 1024, the region padded to 4096 lines."""
    from repro_torch.capture.kv_serve import (
        LINES_PER_PAGE,
        LINES_PER_TOKEN,
        KVServeConfig,
        capture_kv_serve,
        pt_line,
        token_lines,
    )

    cfg = KVServeConfig(num_pages=8, shared_pages=1, batch=2,
                        fixed_prompt_tokens=2, fixed_decode_tokens=100,
                        attn_reads_per_req=0)
    tr = capture_kv_serve(threads=16, seed=0, num_kernels=2,
                          windows_per_kernel=2, cfg=cfg, device="cpu")
    assert tr.num_lines == 4096
    assert tr.num_windows == 4 and tr.num_kernels == 2

    def tok(page, slot):
        return list(range(page * 128 + slot * 8, page * 128 + slot * 8 + 8))

    def row(t, w):
        r = t[w].numpy()
        return list(r[r >= 0])

    PT = 1024
    for s in range(4):
        assert row(tr.pim_writes, s) == tok(1, 2 + s) + tok(2, 2 + s), f"step {s}"
        assert row(tr.pim_reads, s) == [PT] + tok(1, 1 + s) + [PT] + tok(2, 1 + s)
        assert bool((tr.cpu_writes[s] == -1).all())
        cr = tr.cpu_reads[s].numpy()
        assert np.all((cr[cr >= 0] >= 0) & (cr[cr >= 0] < 128))
    pre0 = set(np.flatnonzero(tr.pre_writes[0].numpy()))
    assert pre0 == (set(range(128)) | set(tok(1, 0)) | set(tok(1, 1))
                    | set(tok(2, 0)) | set(tok(2, 1)) | {PT})
    assert set(np.flatnonzero(tr.pre_writes[1].numpy())) == {PT}

    # past the page boundary: step 14 writes slot 0 of fresh pages 3 and 4,
    # and the scheduler writes their page-table entries (the RAW race)
    tr2 = capture_kv_serve(threads=16, seed=0, num_kernels=8,
                           windows_per_kernel=2, cfg=cfg, device="cpu")
    assert row(tr2.pim_writes, 14) == tok(3, 0) + tok(4, 0)
    assert row(tr2.pim_reads, 14) == [PT] + tok(1, 15) + [PT] + tok(2, 15)
    assert row(tr2.cpu_writes, 14) == [PT, PT]

    layout = cfg.layout()
    assert list(token_lines(layout, 2, 3)) == tok(2, 3)
    assert pt_line(layout, 7) == PT
    assert LINES_PER_PAGE == 128 and LINES_PER_TOKEN == 8
    with pytest.raises(ValueError, match="page pool too small"):
        capture_kv_serve(cfg=KVServeConfig(num_pages=8, shared_pages=4, batch=8),
                         device="cpu")


def test_kv_serve_capture_trace_entry_point():
    t = capture_trace(KV_APP, seed=2, cpu_reuse=5.0, device="cpu", **TINY)
    assert t.cpu_reuse == 5.0
    _assert_same_trace(r_make_trace(KV_APP, seed=2, cpu_reuse=5.0, **TINY), t)


@pytest.mark.parametrize("engine", ["batch", "sequential"])
def test_kv_serve_study_matches_reference(engine):
    """At a quarter of the default scale and 8 kernels (the default scale
    runs on the card in ``chip_smoke.py``, against this CPU path)."""
    from repro.api import Study as RStudy
    from repro.api import workload as r_workload
    from repro_torch.api import Study, workload

    kw = dict(scale=0.25, num_kernels=8)
    got = Study([workload(KV_APP, **kw)], device="cpu").run(engine=engine)
    want = RStudy([r_workload(KV_APP, **kw)]).run(engine=engine)
    assert [p.workload for p in got] == [p.workload for p in want]
    assert len(got.points) == 1
    for a, b in zip(got.points, want.points):
        assert set(a.results) == set(b.results)
        for m in b.results:
            assert dataclasses.asdict(a.results[m]) == dataclasses.asdict(b.results[m]), m
