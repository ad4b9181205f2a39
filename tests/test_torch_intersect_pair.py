"""The pair-and-any form of ``bloom_intersect`` (B4) on the CPU: both
CPUWriteSet banks of a LazyPIM window against the read images, and per bank
and lane whether any register passes the AND-prefilter.  Its plain version
(the CPU path of the wrapper) against two per-row calls and their ``.any``
at several lane, register and segment counts (all-zero banks and images
included), and against ``repro``: ``conflict_any`` on each bank and the
fused ``conflict_from_hits``, on traces and bitmaps made from numpy seeds.
Then the LazyPIM window's one ``bloom_intersect`` call (both commit modes),
and the wrapper's kernel path through a stand-in library: one launch and
one count a pair, a launch error raised and not counted, the plain version
never run.  Boolean results, so every comparison is exact."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import signatures as RS
from repro.sim import prep as RP
from repro.sim.trace import make_trace as r_make_trace
from repro_torch.core import signatures as S
from repro_torch.kernels.bloom import bloom as K
from repro_torch.sim import prep as TP
from repro_torch.sim.trace import trace_from_numpy

SPECS = [(2048, 4), (1024, 2)]  # the paper's registers, and a smaller geometry


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module's small CPU ops, so parallel test
    workers do not oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _pair(sig_bits: int, m: int):
    """One small trace (6409 lines) prepared by both packages with the same
    spec."""
    rt = r_make_trace("pagerank", "arxiv", num_kernels=4)
    fields = {f.name: np.asarray(getattr(rt, f.name)) for f in dataclasses.fields(rt)}
    r_spec = RS.SignatureSpec(sig_bits=sig_bits, num_segments=m)
    t_spec = S.SignatureSpec(sig_bits=sig_bits, num_segments=m)
    return (RP.prepare(rt, r_spec),
            TP.prepare(trace_from_numpy(fields, "cpu"), t_spec, device="cpu"))


def _bitmaps(n, lanes, density, seed):
    """The same random packed line bitmaps (zero pad bits) for both."""
    bits = np.random.default_rng(seed).random((lanes, n)) < density
    words = np.stack([np.asarray(RP.pack_bitmap(jnp.asarray(b))) for b in bits])
    return words, torch.from_numpy(words.view(np.int32))


def _words(shape, density, seed):
    bits = np.random.default_rng(seed).random((*shape, 32)) < density
    packed = np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)
    return torch.from_numpy(packed.reshape(shape).view(np.int32))


@pytest.mark.parametrize("lanes", [1, 3, 48])
@pytest.mark.parametrize("regs", [1, 16])
@pytest.mark.parametrize("m", [1, 4, 32])
@pytest.mark.parametrize("kind", ["random", "zeros"])
def test_pair_equals_two_per_row_calls(lanes, regs, m, kind):
    """(2, L): bank k, lane l is the .any over lane l's registers of the
    per-row form on bank k; all-zero banks and images give False."""
    nw = 64
    seed = lanes * 1000 + regs * 10 + m
    dens = 0.0 if kind == "zeros" else 0.15
    a = _words((lanes * regs, nw), dens, seed)
    a_b = _words((lanes * regs, nw), dens / 3, seed + 1)
    b = _words((lanes, nw), 0.0 if kind == "zeros" else 0.3, seed + 2)
    got = K.bloom_intersect(a, b, m, a_b=a_b)
    assert got.dtype == torch.bool and got.shape == (2, lanes)
    want = torch.stack([K.bloom_intersect(x, b, m).reshape(lanes, regs).any(1)
                        for x in (a, a_b)])
    assert torch.equal(got, want)
    if kind == "zeros":
        assert not got.any()


@pytest.mark.parametrize("sig_bits,m", SPECS)
@pytest.mark.parametrize("density_a,density_b", [(0.0, 0.01), (0.002, 0.3), (0.05, 0.0)])
def test_pair_equals_reference_conflict_checks(sig_bits, m, density_a, density_b):
    """``conflict_any_pair`` on every window's read image (one lane a window)
    equals ``repro``'s ``conflict_any`` of each bank and its fused
    ``conflict_from_hits``, and the port's two ``conflict_any`` calls."""
    rtt, ttt = _pair(sig_bits, m)
    lanes = ttt.num_windows
    ra, ta = _bitmaps(rtt.num_lines, lanes, density_a, seed=int(density_a * 1e4) + m)
    rb, tb = _bitmaps(rtt.num_lines, lanes, density_b, seed=int(density_b * 1e4) + 7)
    read = TP.sig_bits_from_ids(ttt, ttt.pim_reads, ttt.pim_r_valid)
    r_read = jax.vmap(lambda i, v: RP.sig_bits_from_ids(rtt, i, v))(rtt.pim_reads,
                                                                     rtt.pim_r_valid)
    np.testing.assert_array_equal(read.numpy().view(np.uint32), np.asarray(r_read))
    bank_a, bank_b = TP.bank_pair_from_bitmaps(ttt, ta, tb)
    got_a, got_b = TP.conflict_any_pair(ttt, read, bank_a, bank_b)
    assert got_a.shape == got_b.shape == (lanes,)
    assert torch.equal(got_a, TP.conflict_any(ttt, read, bank_a))
    assert torch.equal(got_b, TP.conflict_any(ttt, read, bank_b))
    for got, words in ((got_a, ra), (got_b, rb)):
        words = jnp.asarray(words)
        unfused = jax.vmap(lambda r, w: RP.conflict_any(
            rtt, r, RP.bank_bits_from_bitmap(rtt, w)))(r_read, words)
        fused = jax.vmap(lambda r, w: RP.conflict_from_hits(
            rtt, w, RP.line_sig_hits(rtt, r)))(r_read, words)
        np.testing.assert_array_equal(got.numpy(), np.asarray(unfused))
        np.testing.assert_array_equal(got.numpy(), np.asarray(fused))
    if density_a == 0.0:
        assert not got_a.any()
    if density_b == 0.3:
        assert got_b.all()  # saturated registers pass against every image


def test_pair_argument_checks():
    a = torch.zeros((6, 64), dtype=torch.int32)
    b = torch.zeros((3, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="a_b"):
        K.bloom_intersect(a, b, 4, a_b=torch.zeros((3, 64), dtype=torch.int32))
    with pytest.raises(TypeError):
        K.bloom_intersect(a, b, 4, a_b=torch.zeros((6, 64), dtype=torch.int64))
    empty = torch.zeros((0, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="register"):
        K.bloom_intersect(empty, b, 4, a_b=empty)


def _cpu_trace():
    from repro_torch.sim.trace import make_trace

    return TP.prepare(make_trace("pagerank", "arxiv", num_kernels=3, device="cpu"),
                      device="cpu")


@pytest.mark.parametrize("partial_commits", [True, False])
def test_lazypim_window_asks_one_intersect(monkeypatch, partial_commits):
    """The LazyPIM window loop makes exactly one ``bloom_intersect`` call a
    window, in the pair-and-any form: both banks against the read image."""
    from repro_torch.core.coherence import LazyPIMConfig
    from repro_torch.sim.costmodel import HWParams
    from repro_torch.sim.engine import run_mechanism

    tt = _cpu_trace()
    calls = []
    real = K.bloom_intersect

    def counted(a, b, num_segments, **kw):
        calls.append((kw.get("a_b") is not None, a.shape[0] // b.shape[0]))
        return real(a, b, num_segments, **kw)

    monkeypatch.setattr(K, "bloom_intersect", counted)
    run_mechanism(tt, HWParams(), "lazypim",
                  LazyPIMConfig(partial_commits=partial_commits), device="cpu")
    assert calls == [(True, TP.CPUWS_REGS)] * tt.num_windows


class _FakeLib:
    """Stands in for the built CUDA library: records launches and their
    arguments, returns ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return self.rc
        return launch


@pytest.mark.parametrize("rc", [0, 700])
def test_pair_kernel_path_launches_once_or_raises(monkeypatch, rc):
    """On the card the pair is one launch and one count with both banks'
    pointers and (L, R, NW, words a segment, M); a launch error raises and
    counts nothing; the plain version is never run."""
    fake = _FakeLib(rc)
    monkeypatch.setattr(K, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(K, "_lib", lambda: fake)
    monkeypatch.setattr(K, "_stream", lambda t: 0)
    monkeypatch.setattr(K, "bloom_intersect_plain", None)  # any use would fail
    a = torch.zeros((48, 64), dtype=torch.int32)
    a_b = torch.ones((48, 64), dtype=torch.int32)
    b = torch.zeros((3, 64), dtype=torch.int32)
    K.reset_launch_counts()
    if rc:
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            K.bloom_intersect(a, b, 4, a_b=a_b)
    else:
        out = K.bloom_intersect(a, b, 4, a_b=a_b)
        assert out.shape == (2, 3) and out.dtype == torch.bool
    assert [name for name, _ in fake.calls] == ["bloom_intersect_pair_launch"]
    args = fake.calls[0][1]
    assert args[:3] == (a.data_ptr(), a_b.data_ptr(), b.data_ptr())
    assert args[4:9] == (3, 16, 64, 16, 4)
    assert K.launch_counts()["bloom_intersect"] == (0 if rc else 1)
    K.reset_launch_counts()
