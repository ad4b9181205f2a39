"""The parity form of H3 that the redesigned ``bloom_query`` (B3) and
``bloom_query_onehot`` (B8b) kernels hash with, on the CPU: its plain
version against the byte-sliced tables, the xor-fold and the reference's
hash; the column-mask cap of both wrappers; ``members_pair`` against two
``members`` calls and against the reference's one gather a signature; the
LazyPIM window's two query launches; and the build digest that keys a
kernel library by its headers too.  Integer results, so every comparison
is exact."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import signatures as RS
from repro.sim import prep as RP
from repro.sim.trace import make_trace as r_make_trace
from repro_torch.core import signatures as S
from repro_torch.kernels import _build
from repro_torch.kernels.bloom import bloom as K
from repro_torch.kernels.bloom import onehot as K8
from repro_torch.sim import prep as TP
from repro_torch.sim.trace import trace_from_numpy


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module's small CPU ops, so parallel test
    workers do not oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _addrs(n: int, seed: int) -> np.ndarray:
    """Seeded uint32 addresses over the full range, with 0, 2^31 and
    2^32 - 1 first."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, size=(n,), dtype=np.uint64).astype(np.uint32)
    return np.concatenate([np.array([0, 2**31, 2**32 - 1], np.uint32), a])


@pytest.mark.parametrize("sig_bits,num_segments,addr_bits", [
    (2048, 4, 32),   # the paper's registers
    (512, 4, 32),
    (4096, 4, 32),
    (2048, 2, 32),
    (2048, 8, 32),
    (2048, 4, 20),
    (4096, 8, 9),
])
def test_parity_equals_tables_xorfold_and_reference(sig_bits, num_segments, addr_bits):
    spec = S.SignatureSpec(sig_bits=sig_bits, num_segments=num_segments,
                           addr_bits=addr_bits)
    r_spec = RS.SignatureSpec(sig_bits=sig_bits, num_segments=num_segments,
                              addr_bits=addr_bits)
    a = _addrs(4000, sig_bits + num_segments + addr_bits)
    t = torch.from_numpy(a.view(np.int32))
    got = S.hash_positions_parity(spec, t)
    assert got.dtype == torch.int32 and got.shape == (a.shape[0], num_segments)
    tables = S.hash_with_tables(t, S.tables_tensor(spec, torch.device("cpu")))
    assert torch.equal(got, tables)
    assert torch.equal(got, S.hash_positions_xorfold(spec, t))
    want = np.asarray(RS.hash_positions(r_spec, jnp.asarray(a)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    cols = S.h3_columns(spec)
    assert cols.dtype == np.uint32 and not cols.flags.writeable
    assert cols.shape == (num_segments, spec.seg_bits.bit_length() - 1)
    assert int(cols.max()) < 2**addr_bits  # only the address's bits take part


def test_columns_transpose_the_h3_matrix():
    spec = S.default_spec()
    q, cols = spec.h3_matrix, S.h3_columns(spec)
    for m in range(spec.num_segments):
        for k in range(cols.shape[1]):
            for j in range(spec.addr_bits):
                assert (int(cols[m, k]) >> j) & 1 == (int(q[m, j]) >> k) & 1


@pytest.mark.parametrize("sig_bits,num_segments", [(2048, 64), (2**17, 1)])
def test_spec_beyond_the_mask_cap_is_refused(monkeypatch, sig_bits, num_segments):
    """More than 32 segments, or segments of more than 2^16 bits, would
    overflow the kernels' 512-word mask struct: on the card both query
    wrappers refuse them before any launch, while the plain versions on
    the CPU take them (B8b keeps its own num_segments <= 32 refusal)."""
    spec = S.SignatureSpec(sig_bits=sig_bits, num_segments=num_segments)
    sig = torch.full((1, spec.num_words), -1, dtype=torch.int32)
    words = torch.full((1, 2), -1, dtype=torch.int32)
    bits = torch.ones((1, spec.sig_bits), dtype=torch.bool)
    addrs = torch.arange(4, dtype=torch.int32)[None]
    assert torch.equal(K.bloom_query(spec, sig, words, 40),
                       K.bloom_query_plain(spec, sig, words, 40))
    if num_segments <= 32:
        assert K8.bloom_query_onehot(spec, bits, addrs).all()
    launched = []
    for mod in (K, K8):  # the tensors taken as CUDA tensors
        monkeypatch.setattr(mod, "_on_cpu", lambda *ts: False)
        monkeypatch.setattr(mod, "_launch", lambda *a: launched.append(a))
    with pytest.raises(ValueError, match="num_segments <= 32"):
        K.bloom_query(spec, sig, words, 40)
    with pytest.raises(ValueError, match="num_segments <= 32"):
        K8.bloom_query_onehot(spec, bits, addrs)
    assert not launched


def test_largest_spec_under_the_cap_is_taken():
    spec = S.SignatureSpec(sig_bits=2**16 * 2, num_segments=2)  # 2 x 16 masks
    cols, log_seg = K._columns(spec)
    assert cols.shape == (2, 16) and log_seg == 16 and cols.flags.c_contiguous
    sig = torch.full((1, spec.num_words), -1, dtype=torch.int32)
    words = torch.full((1, 2), -1, dtype=torch.int32)
    assert torch.equal(K.bloom_query(spec, sig, words, 64), words)


@pytest.fixture(scope="module")
def pair():
    """One small trace prepared by both packages (6409 lines: the last
    bitmap word has pad bits)."""
    rt = r_make_trace("pagerank", "arxiv", num_kernels=4)
    fields = {f.name: np.asarray(getattr(rt, f.name))
              for f in dataclasses.fields(rt)}
    return RP.prepare(rt), TP.prepare(trace_from_numpy(fields, "cpu"), device="cpu")


def _bitmaps(n, lanes, density, seed):
    bits = np.random.default_rng(seed).random((lanes, n)) < density
    words = np.stack([np.asarray(RP.pack_bitmap(jnp.asarray(b))) for b in bits])
    return words, torch.from_numpy(words.view(np.int32))


@pytest.mark.parametrize("density_a,density_b", [(0.0, 0.0), (0.002, 0.3),
                                                 (0.5, 0.0), (1.0, 0.05)])
def test_members_pair_equals_members_and_reference(pair, density_a, density_b):
    rtt, ttt = pair
    lanes = 4
    ra, ta = _bitmaps(rtt.num_lines, lanes, density_a, seed=3)
    rb, tb = _bitmaps(rtt.num_lines, lanes, density_b, seed=5)
    sig_r = jax.vmap(lambda i, v: RP.sig_bits_from_ids(rtt, i, v))(
        rtt.pim_reads[:lanes], rtt.pim_r_valid[:lanes])
    sig_t = TP.sig_bits_from_ids(ttt, ttt.pim_reads[:lanes], ttt.pim_r_valid[:lanes])
    got_a, got_b = TP.members_pair(ttt, ta, tb, sig_t)
    assert torch.equal(got_a, TP.members(ttt, ta, sig_t))
    assert torch.equal(got_b, TP.members(ttt, tb, sig_t))
    for words, got in ((ra, got_a), (rb, got_b)):
        want = jax.vmap(lambda w, s: RP.members_from_hits(w, RP.line_sig_hits(rtt, s)))(
            jnp.asarray(words), sig_r)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    if density_a == 1.0:
        assert 0 < int(TP.popcount_words(got_a).sum()) < lanes * ttt.num_lines


def test_pair_plain_keeps_pad_bits_zero():
    spec = S.default_spec()
    words = torch.full((2, 2), -1, dtype=torch.int32)
    sig = torch.full((2, spec.num_words), -1, dtype=torch.int32)
    a, b = K.bloom_query(spec, sig, words, 40, words_b=words.clone())
    want = torch.tensor([-1, 0xFF], dtype=torch.int32).expand(2, 2)
    assert torch.equal(a, want) and torch.equal(b, want)


@pytest.mark.parametrize("partial_commits", [True, False])
def test_lazypim_window_asks_two_queries(monkeypatch, partial_commits):
    """The LazyPIM window loop makes exactly two ``bloom_query`` calls a
    window (the read image for dirty and conc, the write image for dirty
    and present), each with two bitmaps."""
    from repro_torch.core.coherence import LazyPIMConfig
    from repro_torch.sim.costmodel import HWParams
    from repro_torch.sim.engine import run_mechanism
    from repro_torch.sim.prep import prepare
    from repro_torch.sim.trace import make_trace

    tt = prepare(make_trace("pagerank", "arxiv", num_kernels=3, device="cpu"),
                 device="cpu")
    calls = []
    real = K.bloom_query

    def counted(*args, **kw):
        calls.append(kw.get("words_b") is not None)
        return real(*args, **kw)

    monkeypatch.setattr(K, "bloom_query", counted)
    run_mechanism(tt, HWParams(), "lazypim",
                  LazyPIMConfig(partial_commits=partial_commits), device="cpu")
    assert len(calls) == 2 * tt.num_windows
    assert all(calls)


def test_library_digest_folds_in_the_headers(tmp_path):
    """A changed header beside the source gives it a new library path, so
    a stale build is never loaded; a changed file of another kind does
    not."""
    src = tmp_path / "k.cu"
    src.write_text('#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text("#pragma once\n")
    (tmp_path / "notes.txt").write_text("one\n")
    first = _build.library_path(src)
    assert first.name.startswith("libk-") and first.parent == _build.BUILD_DIR
    (tmp_path / "notes.txt").write_text("two\n")
    assert _build.library_path(src) == first
    (tmp_path / "a.cuh").write_text("#pragma once\n// changed\n")
    second = _build.library_path(src)
    assert second != first
    (tmp_path / "b.cuh").write_text("// new\n")
    assert _build.library_path(src) not in (first, second)
