"""The parity form of H3 that the redesigned ``bloom_query`` (B3) and
``bloom_query_onehot`` (B8b) kernels hash with, on the CPU: its plain
version against the byte-sliced tables, the xor-fold and the reference's
hash; specs past the kernels' old column-mask cap, taken in passes through
a stand-in library; ``members_pair`` against two
``members`` calls and against the reference's one gather a signature; the
LazyPIM window's two query launches; and the build digest that keys a
kernel library by its headers too.  Integer results, so every comparison
is exact."""

from __future__ import annotations

import ctypes
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


def _view(ptr: int, dtype, shape) -> np.ndarray:
    """A writable numpy view of ``shape`` elements at host address ``ptr``."""
    count = int(np.prod(shape)) * np.dtype(dtype).itemsize
    return np.frombuffer((ctypes.c_char * count).from_address(ptr), dtype=dtype).reshape(
        shape)


def _parity_positions(cols: np.ndarray, m0: int, log_seg: int, a: np.ndarray) -> np.ndarray:
    """(N, M) positions of addresses ``a`` under one pass's column masks:
    ((m0 + m) << log_seg) | h, bit k of h the parity of a & cols[m, k]."""
    x = a.astype(np.uint64)[:, None, None] & cols.astype(np.uint64)[None]
    for shift in (16, 8, 4, 2, 1):
        x ^= x >> np.uint64(shift)
    h = ((x & np.uint64(1)) << np.arange(log_seg, dtype=np.uint64)).sum(-1)
    m = np.arange(m0, m0 + cols.shape[0], dtype=np.uint64)
    return (m << np.uint64(log_seg)) | h


def _all_set(sig_row: np.ndarray, pos: np.ndarray) -> np.ndarray:
    return ((sig_row[pos >> np.uint64(5)] >> (pos & np.uint64(31)).astype(np.uint32))
            & 1).astype(bool).all(-1)


class _ParityLib:
    """Stands in for the built libraries' two query launchers: runs one
    pass of the parity-form membership in numpy on the host memory the
    launch's pointers name (CPU tensors taken as CUDA ones), so the result
    checks the passes the wrapper drives.  Records every launch."""

    def __init__(self):
        self.calls = []

    def bloom_query_launch(self, sig, words_a, words_b, columns, out_a, out_b, lanes,
                           nwl, num_lines, m, log_seg, m0, nw, stream):
        self.calls.append(("bloom_query_launch", m, log_seg, m0))
        cols = _view(columns, np.uint32, (m, log_seg))
        sigs = _view(sig, np.uint32, (lanes, nw))
        srcs = [_view(p, np.uint32, (lanes, nwl)) for p in (words_a, words_b) if p]
        outs = [_view(p, np.uint32, (lanes, nwl)) for p in (out_a, out_b) if p]
        for lane in range(lanes):
            union = np.bitwise_or.reduce([w[lane] for w in srcs])
            bits = np.unpackbits(union.view(np.uint8), bitorder="little")[:num_lines]
            lines = np.nonzero(bits)[0].astype(np.uint32)
            hit = np.zeros(nwl * 32, bool)
            hit[lines[_all_set(sigs[lane], _parity_positions(cols, m0, log_seg, lines))]] = 1
            packed = np.packbits(hit, bitorder="little").view(np.uint32)
            for src, out in zip(srcs, outs):
                out[lane] = src[lane] & packed
        return 0

    def bloom_query_onehot_launch(self, bits, addrs, columns, out, lanes, n, m, log_seg,
                                  m0, and_out, sig_bits, stream):
        self.calls.append(("bloom_query_onehot_launch", m, log_seg, m0, and_out))
        cols = _view(columns, np.uint32, (m, log_seg))
        image = _view(bits, np.uint8, (lanes, sig_bits)).astype(bool)
        a = _view(addrs, np.uint32, (lanes, n))
        o = _view(out, np.uint8, (lanes, n))
        for lane in range(lanes):
            pos = _parity_positions(cols, m0, log_seg, a[lane]).astype(np.int64)
            member = image[lane][pos].all(-1)
            o[lane] = (o[lane].astype(bool) & member) if and_out else member
        return 0


@pytest.mark.parametrize("sig_bits,num_segments", [(2048, 64), (2**17, 1)])
def test_spec_beyond_the_mask_cap_is_refused(monkeypatch, sig_bits, num_segments):
    """Specs past the kernels' old caps (more than 32 segments; segments of
    more than 2^16 bits) are taken on the card, as repro takes them: each
    query wrapper hashes a spec in passes of at most 512 column masks, one
    launch a pass, and gives its plain version's result.  The spec itself
    fits one pass; the spec with twice the segments of twice the bits
    ((4096, 128): 640 masks) takes two, the second from segment 102."""
    lib = _ParityLib()
    for spec in (S.SignatureSpec(sig_bits=sig_bits, num_segments=num_segments),
                 S.SignatureSpec(sig_bits=2 * sig_bits, num_segments=2 * num_segments)):
        log_seg = spec.seg_bits.bit_length() - 1
        per = 512 // log_seg
        want_passes = [(min(per, spec.num_segments - m0), log_seg, m0)
                       for m0 in range(0, spec.num_segments, per)]
        g = torch.Generator().manual_seed(sig_bits + num_segments)
        # dense enough that about half the addresses are members at any M
        sig = torch.rand((2, spec.num_words, 32), generator=g) < 1 - 0.5 / spec.num_segments
        sig = S.pack_words(sig.reshape(2, -1))
        words = S.pack_words(torch.rand((2, 96), generator=g) < 0.5)
        words_b = S.pack_words(torch.rand((2, 96), generator=g) < 0.5)
        bits = S.unpack_words(sig, spec.sig_bits).contiguous()
        addrs = torch.randint(-2**31, 2**31 - 1, (2, 300), generator=g, dtype=torch.int32)
        plain = (K.bloom_query_plain(spec, sig, words, 90),
                 K.bloom_query_plain(spec, sig, words, 90, words_b),
                 K8.bloom_query_onehot_plain(spec, bits, addrs))
        assert 0 < int(plain[2].sum()) < plain[2].numel()  # members vary
        with monkeypatch.context() as mp:
            for mod in (K, K8):  # the tensors taken as CUDA tensors
                mp.setattr(mod, "_on_cpu", lambda *ts: False)
                mp.setattr(mod, "_lib", lambda: lib)
                mp.setattr(mod, "_stream", lambda t: 0)
            K.reset_launch_counts()
            K8.reset_launch_counts()
            lib.calls.clear()
            assert torch.equal(K.bloom_query(spec, sig, words, 90), plain[0])
            got = K.bloom_query(spec, sig, words, 90, words_b=words_b)
            assert torch.equal(got[0], plain[1][0]) and torch.equal(got[1], plain[1][1])
            assert torch.equal(K8.bloom_query_onehot(spec, bits, addrs), plain[2])
        q = [c[1:] for c in lib.calls if c[0] == "bloom_query_launch"]
        assert q == want_passes * 2
        onehot = [c[1:] for c in lib.calls if c[0] == "bloom_query_onehot_launch"]
        assert onehot == [(*p, int(i > 0)) for i, p in enumerate(want_passes)]
        assert K.launch_counts()["bloom_query"] == 2 * len(want_passes)
        assert K8.launch_counts()["bloom_query_onehot"] == len(want_passes)
    K.reset_launch_counts()
    K8.reset_launch_counts()


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
