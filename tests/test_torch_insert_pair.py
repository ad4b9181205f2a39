"""The insert kernels' pair forms on the CPU: ``bloom_insert`` (B2) given two
id lists or two bitmaps, and ``bloom_insert_onehot`` (B8a) given two address
lists and an optional incoming signature.  Their plain versions (the CPU
path of each wrapper) against two single calls and against ``repro``: the
prep primitives ``sig_bits_from_ids`` / ``bank_bits_from_bitmap`` at two
specs and several bitmap densities, and the Pallas kernel
``bloom_insert_pallas_onehot`` in interpret mode.  Then the LazyPIM window's
two ``bloom_insert`` calls (one for the images, one for the banks) and the
seed window's one B8a call, in both commit modes; and the wrappers' kernel
path through stand-in libraries: one count a pair launch, specs past the
old column-mask cap inserted in passes, and more than 65,535 lanes in one
launch.  Integer results, so every comparison is exact."""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import signatures as RS
from repro.kernels.bloom import bloom as RK
from repro.sim import prep as RP
from repro.sim.trace import make_trace as r_make_trace
from repro_torch.core import signatures as S
from repro_torch.kernels.bloom import bloom as K
from repro_torch.kernels.bloom import onehot as K8
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
    """One small trace (6409 lines: the last bitmap word has pad bits)
    prepared by both packages with the same spec."""
    rt = r_make_trace("pagerank", "arxiv", num_kernels=4)
    fields = {f.name: np.asarray(getattr(rt, f.name)) for f in dataclasses.fields(rt)}
    r_spec = RS.SignatureSpec(sig_bits=sig_bits, num_segments=m)
    t_spec = S.SignatureSpec(sig_bits=sig_bits, num_segments=m)
    return (RP.prepare(rt, r_spec),
            TP.prepare(trace_from_numpy(fields, "cpu"), t_spec, device="cpu"))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _bitmaps(n, lanes, density, seed):
    """The same random packed line bitmaps (zero pad bits) for both."""
    bits = np.random.default_rng(seed).random((lanes, n)) < density
    words = np.stack([np.asarray(RP.pack_bitmap(jnp.asarray(b))) for b in bits])
    return words, torch.from_numpy(words.view(np.int32))


@pytest.mark.parametrize("sig_bits,m", SPECS)
def test_ids_pair_equals_two_singles_and_reference(sig_bits, m):
    rtt, ttt = _pair(sig_bits, m)
    valid_b = ttt.pim_w_valid.clone()
    valid_b[2] = False  # an all-invalid list gives zeros
    got_a, got_b = TP.sig_bits_pair_from_ids(ttt, ttt.pim_reads, ttt.pim_r_valid,
                                             ttt.pim_writes, valid_b)
    assert got_a.shape == got_b.shape == (ttt.num_windows, ttt.sig_words)
    assert torch.equal(got_a, TP.sig_bits_from_ids(ttt, ttt.pim_reads, ttt.pim_r_valid))
    assert torch.equal(got_b, TP.sig_bits_from_ids(ttt, ttt.pim_writes, valid_b))
    assert not got_b[2].any() and got_a[2].any()
    for got, ids, valid in ((got_a, rtt.pim_reads, rtt.pim_r_valid),
                            (got_b, rtt.pim_writes, jnp.asarray(valid_b.numpy()))):
        want = jax.vmap(lambda i, v: RP.sig_bits_from_ids(rtt, i, v))(ids, valid)
        np.testing.assert_array_equal(_u32(got), np.asarray(want))


def test_ids_pair_takes_lists_of_two_widths():
    """The second list may have its own slot count; the CPUWriteSet bank
    form (num_regs = 16) pairs too."""
    spec = S.default_spec()
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 5000, size=(3, 40)).astype(np.int32))
    ids_b = torch.from_numpy(rng.integers(0, 5000, size=(3, 7)).astype(np.int32))
    valid, valid_b = ids >= 1000, ids_b >= 0
    for regs in (1, 16):
        a, b = K.bloom_insert(spec, ids=ids, valid=valid, ids_b=ids_b, valid_b=valid_b,
                              num_regs=regs)
        assert a.shape == b.shape == (3, regs, spec.num_words)
        assert torch.equal(a, K.bloom_insert(spec, ids=ids, valid=valid, num_regs=regs))
        assert torch.equal(b, K.bloom_insert(spec, ids=ids_b, valid=valid_b,
                                             num_regs=regs))


@pytest.mark.parametrize("sig_bits,m", SPECS)
@pytest.mark.parametrize("density_a,density_b", [(0.0, 0.01), (0.002, 0.3)])
def test_bank_pair_equals_two_singles_and_reference(sig_bits, m, density_a, density_b):
    rtt, ttt = _pair(sig_bits, m)
    ra, ta = _bitmaps(rtt.num_lines, 3, density_a, seed=int(density_a * 1e4) + m)
    rb, tb = _bitmaps(rtt.num_lines, 3, density_b, seed=int(density_b * 1e4) + 7)
    got_a, got_b = TP.bank_pair_from_bitmaps(ttt, ta, tb)
    assert got_a.shape == got_b.shape == (3, TP.CPUWS_REGS, ttt.sig_words)
    assert torch.equal(got_a, TP.bank_bits_from_bitmap(ttt, ta))
    assert torch.equal(got_b, TP.bank_bits_from_bitmap(ttt, tb))
    if density_a == 0.0:
        assert not got_a.any()  # an empty bitmap gives zeros
    for got, words in ((got_a, ra), (got_b, rb)):
        want = jax.vmap(lambda w: RP.bank_bits_from_bitmap(rtt, w))(jnp.asarray(words))
        np.testing.assert_array_equal(_u32(got), np.asarray(want))
    one_a, one_b = K.bloom_insert(ttt.spec, bitmap=ta, bitmap_b=tb,
                                  num_lines=ttt.num_lines)
    for got, words in ((one_a, ra), (one_b, rb)):  # one register: the images
        want = jax.vmap(lambda w: RP.sig_bits_from_bitmap(rtt, w))(jnp.asarray(words))
        np.testing.assert_array_equal(_u32(got[:, 0]), np.asarray(want))


def test_pair_forms_check_arguments():
    spec = S.default_spec()
    ids = torch.zeros((2, 4), dtype=torch.int32)
    valid = torch.ones((2, 4), dtype=torch.bool)
    words = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="lanes"):
        K.bloom_insert(spec, ids=ids, valid=valid, ids_b=ids[:1], valid_b=valid[:1])
    with pytest.raises(ValueError):
        K.bloom_insert(spec, ids=ids, valid=valid, ids_b=ids, valid_b=valid[:, :3])
    with pytest.raises(ValueError, match="bitmap_b"):
        K.bloom_insert(spec, bitmap=words, num_lines=40, bitmap_b=words[:, :1])
    with pytest.raises(ValueError, match="pairs with"):
        K.bloom_insert(spec, ids=ids, valid=valid, bitmap_b=words)
    with pytest.raises(ValueError, match="pairs with"):
        K.bloom_insert(spec, bitmap=words, num_lines=40, ids_b=ids, valid_b=valid)
    addrs = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="lanes"):
        K8.bloom_insert_onehot(spec, None, addrs, addrs_b=addrs[:1])
    with pytest.raises(ValueError, match="mask_b"):
        K8.bloom_insert_onehot(spec, None, addrs, mask_b=valid)
    with pytest.raises(ValueError, match="mask_b"):
        K8.bloom_insert_onehot(spec, None, addrs, addrs_b=addrs, mask_b=valid[:, :3])


# ---------------------------------------------------------------------------
# B8a: the plain pair against the Pallas one-hot kernel in interpret mode
# ---------------------------------------------------------------------------

N_A, N_B = 300, 130  # ragged against the reference's block of 64
BLOCK_N = 64


@functools.lru_cache(maxsize=None)
def _r_insert(sig_bits, m):
    r_spec = RS.SignatureSpec(sig_bits=sig_bits, num_segments=m)
    return jax.jit(lambda sig, addrs, mask: RK.bloom_insert_pallas_onehot(
        r_spec, sig, addrs, mask, block_n=BLOCK_N, interpret=True))


def _addrs(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n,), dtype=np.uint64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    a = a.view(np.int32) if a.dtype == np.uint32 else a
    return torch.from_numpy(a.copy())[None]


@pytest.mark.parametrize("sig_bits,m", SPECS)
@pytest.mark.parametrize("with_sig", [False, True], ids=["no_sig", "sig"])
def test_onehot_pair_equals_pallas_onehot(sig_bits, m, with_sig):
    spec = S.SignatureSpec(sig_bits=sig_bits, num_segments=m)
    a, b = _addrs(N_A, sig_bits + m), _addrs(N_B, sig_bits * m)
    mask_a = np.random.default_rng(m).integers(0, 2, size=(N_A,)).astype(bool)
    mask_b = np.zeros((N_B,), bool)  # an all-false list
    sig0 = np.zeros((spec.num_words,), np.uint32)
    if with_sig:
        sig0[::3] = 0x80000001  # an incoming signature with bits already set
    got = K8.bloom_insert_onehot(spec, _t(sig0) if with_sig else None, _t(a), _t(mask_a),
                                 addrs_b=_t(b), mask_b=_t(mask_b))
    assert isinstance(got, tuple) and len(got) == 2
    for out, addrs, mask in ((got[0], a, mask_a), (got[1], b, mask_b)):
        assert out.dtype == torch.int32 and out.shape == (1, spec.num_words)
        want = _r_insert(sig_bits, m)(jnp.asarray(sig0), jnp.asarray(addrs),
                                      jnp.asarray(mask))
        np.testing.assert_array_equal(out[0].numpy().view(np.uint32), np.asarray(want))
    np.testing.assert_array_equal(got[1][0].numpy().view(np.uint32), sig0)
    single = K8.bloom_insert_onehot(spec, _t(sig0) if with_sig else None, _t(a), _t(mask_a))
    assert torch.equal(single, got[0])


def test_onehot_pair_of_bool_images_equals_singles():
    """The seed window's pair primitive equals two single calls and the
    packed images of the word-level insert."""
    rtt, ttt = _pair(2048, 4)
    a, b = TP.sig_bits_pair_from_ids_bool(ttt, ttt.pim_reads, ttt.pim_r_valid,
                                          ttt.pim_writes, ttt.pim_w_valid)
    assert a.dtype == torch.bool and a.shape == (ttt.num_windows, ttt.sig_bits)
    assert torch.equal(a, TP.sig_bits_from_ids_bool(ttt, ttt.pim_reads, ttt.pim_r_valid))
    assert torch.equal(b, TP.sig_bits_from_ids_bool(ttt, ttt.pim_writes, ttt.pim_w_valid))
    assert torch.equal(TP.pack_bitmap(b),
                       TP.sig_bits_from_ids(ttt, ttt.pim_writes, ttt.pim_w_valid))
    want = jax.vmap(lambda i, v: RP.sig_bits_from_ids_bool(rtt, i, v))(
        rtt.pim_reads, rtt.pim_r_valid)
    np.testing.assert_array_equal(a.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Calls a window
# ---------------------------------------------------------------------------


def _cpu_trace():
    from repro_torch.sim.prep import prepare
    from repro_torch.sim.trace import make_trace

    return prepare(make_trace("pagerank", "arxiv", num_kernels=3, device="cpu"),
                   device="cpu")


@pytest.mark.parametrize("partial_commits", [True, False])
def test_lazypim_window_asks_two_inserts(monkeypatch, partial_commits):
    """The LazyPIM window loop makes exactly two ``bloom_insert`` calls a
    window: the read and write images from the two id lists, and the
    ``cpuws`` and ``conc`` banks from the two bitmaps."""
    from repro_torch.core.coherence import LazyPIMConfig
    from repro_torch.sim.costmodel import HWParams
    from repro_torch.sim.engine import run_mechanism

    tt = _cpu_trace()
    calls = []
    real = K.bloom_insert

    def counted(*args, **kw):
        form = "ids" if kw.get("ids_b") is not None else (
            "banks" if kw.get("bitmap_b") is not None else "single")
        calls.append((form, kw.get("num_regs", 1)))
        return real(*args, **kw)

    monkeypatch.setattr(K, "bloom_insert", counted)
    run_mechanism(tt, HWParams(), "lazypim",
                  LazyPIMConfig(partial_commits=partial_commits), device="cpu")
    assert len(calls) == 2 * tt.num_windows
    assert calls == [("ids", 1), ("banks", TP.CPUWS_REGS)] * tt.num_windows


@pytest.mark.parametrize("partial_commits", [True, False])
def test_seed_window_asks_one_onehot_insert(monkeypatch, partial_commits):
    """The seed LazyPIM window makes exactly one ``bloom_insert_onehot``
    call: the read and write images from one pair, with no incoming
    signature."""
    from repro_torch.core._boolref import simulate_lazypim_bool
    from repro_torch.core.coherence import LazyPIMConfig
    from repro_torch.sim.costmodel import HWParams

    tt = _cpu_trace()
    calls = []
    real = TP.bloom_insert_onehot

    def counted(spec, sig, addrs, mask=None, **kw):
        calls.append((sig is None, kw.get("addrs_b") is not None))
        return real(spec, sig, addrs, mask, **kw)

    monkeypatch.setattr(TP, "bloom_insert_onehot", counted)
    simulate_lazypim_bool(tt, HWParams(), LazyPIMConfig(partial_commits=partial_commits))
    assert calls == [(True, True)] * tt.num_windows


# ---------------------------------------------------------------------------
# The kernel path through a stand-in library
# ---------------------------------------------------------------------------


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


def _on_card(monkeypatch, mod, fake):
    monkeypatch.setattr(mod, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(mod, "_lib", lambda: fake)
    monkeypatch.setattr(mod, "_stream", lambda t: 0)


@pytest.mark.parametrize("rc", [0, 700])
def test_pair_launch_counts_one(monkeypatch, rc):
    """Each pair is one launch and one count, with both lists' pointers;
    a launch error raises and counts nothing."""
    spec = S.default_spec()
    fake = _FakeLib(rc)
    _on_card(monkeypatch, K, fake)
    _on_card(monkeypatch, K8, fake)
    for mod in (K, K8):
        for name in mod.KERNELS:
            monkeypatch.setattr(mod, f"{name}_plain", None)  # any use would fail
    ids = torch.zeros((3, 8), dtype=torch.int32)
    valid = torch.ones((3, 8), dtype=torch.bool)
    words = torch.zeros((3, 2), dtype=torch.int32)
    calls = [
        lambda: K.bloom_insert(spec, ids=ids, valid=valid, ids_b=ids[:, :5].contiguous(),
                               valid_b=valid[:, :5].contiguous()),
        lambda: K.bloom_insert(spec, bitmap=words, bitmap_b=words, num_lines=40,
                               num_regs=16),
        lambda: K8.bloom_insert_onehot(spec, None, ids, valid, addrs_b=ids),
    ]
    K.reset_launch_counts()
    K8.reset_launch_counts()
    for call in calls:
        if rc:
            with pytest.raises(RuntimeError, match="CUDA error 700"):
                call()
        else:
            a, b = call()
            assert a.shape == b.shape and a.data_ptr() != b.data_ptr()
    names = [name for name, _ in fake.calls]
    assert names == ["bloom_insert_ids_launch", "bloom_insert_bitmap_launch",
                     "bloom_insert_onehot_launch"]
    ids_args, bitmap_args, onehot_args = (args for _, args in fake.calls)
    assert ids_args[2] is not None and ids_args[3] is not None   # ids_b, valid_b
    assert ids_args[6:10] == (2, 3, 8, 5)                         # lists, lanes, widths
    assert bitmap_args[1] is not None and bitmap_args[4] == 2     # bitmap_b, lists
    assert onehot_args[2] is not None and onehot_args[4] is None  # addrs_b, no sig
    assert onehot_args[7] == 2                                    # lists
    want = 0 if rc else 1
    assert K.launch_counts()["bloom_insert"] == 2 * want
    assert K8.launch_counts()["bloom_insert_onehot"] == want
    K.reset_launch_counts()
    K8.reset_launch_counts()


def _view(ptr: int, dtype, shape) -> np.ndarray:
    """A writable numpy view of ``shape`` elements at host address ``ptr``."""
    count = int(np.prod(shape)) * np.dtype(dtype).itemsize
    return np.frombuffer((ctypes.c_char * count).from_address(ptr), dtype=dtype).reshape(
        shape)


def _parity_positions(cols: np.ndarray, m0: int, log_seg: int, a: np.ndarray) -> np.ndarray:
    """(N, M) positions of addresses ``a`` under one pass's column masks."""
    x = a.astype(np.uint64)[:, None, None] & cols.astype(np.uint64)[None]
    for shift in (16, 8, 4, 2, 1):
        x ^= x >> np.uint64(shift)
    h = ((x & np.uint64(1)) << np.arange(log_seg, dtype=np.uint64)).sum(-1)
    m = np.arange(m0, m0 + cols.shape[0], dtype=np.uint64)
    return (m << np.uint64(log_seg)) | h


class _InsertLib:
    """Stands in for the built libraries' insert launchers: runs one pass
    of the parity-form insert in numpy on the host memory the launch's
    pointers name (CPU tensors taken as CUDA ones) -- each item's positions
    ORed into register item % R, the incoming signature and, past the first
    pass, the words out holds ORed in -- so the result checks the passes
    the wrapper drives.  Records every launch."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _store(out, items, cols, m0, log_seg, sig, or_out):
        """out (R, NW) of one (list, lane) from its items (uint32)."""
        regs, nw = out.shape
        bank = np.zeros((regs, nw * 32), bool)
        pos = _parity_positions(cols, m0, log_seg, items).astype(np.int64)
        bank[(items % regs).astype(np.int64)[:, None], pos] = True
        words = np.packbits(bank, axis=1, bitorder="little").view(np.uint32)
        if sig is not None:
            words = words | sig
        out[:] = words | (out if or_out else 0)

    def bloom_insert_ids_launch(self, ids_a, valid_a, ids_b, valid_b, columns, out, k,
                                lanes, a_a, a_b, m, log_seg, m0, or_out, regs, nw, stream):
        self.calls.append(("bloom_insert_ids_launch", k, lanes, m, log_seg, m0, or_out))
        cols = _view(columns, np.uint32, (m, log_seg))
        o = _view(out, np.uint32, (k, lanes, regs, nw))
        for lst, (ids, valid, width) in enumerate(((ids_a, valid_a, a_a),
                                                   (ids_b, valid_b, a_b))[:k]):
            a = _view(ids, np.uint32, (lanes, width))
            v = _view(valid, np.uint8, (lanes, width)).astype(bool)
            for lane in range(lanes):
                self._store(o[lst, lane], a[lane][v[lane]], cols, m0, log_seg, None, or_out)
        return 0

    def bloom_insert_bitmap_launch(self, words_a, words_b, columns, out, k, lanes, nwl,
                                   num_lines, m, log_seg, m0, or_out, regs, nw, stream):
        self.calls.append(("bloom_insert_bitmap_launch", k, lanes, m, log_seg, m0, or_out))
        cols = _view(columns, np.uint32, (m, log_seg))
        o = _view(out, np.uint32, (k, lanes, regs, nw))
        for lst, ptr in enumerate((words_a, words_b)[:k]):
            w = _view(ptr, np.uint32, (lanes, nwl))
            for lane in range(lanes):
                bits = np.unpackbits(w[lane].view(np.uint8), bitorder="little")[:num_lines]
                lines = np.nonzero(bits)[0].astype(np.uint32)
                self._store(o[lst, lane], lines, cols, m0, log_seg, None, or_out)
        return 0

    def bloom_insert_onehot_launch(self, addrs_a, mask_a, addrs_b, mask_b, sig, columns,
                                   out, k, lanes, n_a, n_b, m, log_seg, m0, or_out, nw,
                                   stream):
        self.calls.append(("bloom_insert_onehot_launch", k, lanes, m, log_seg, m0, or_out))
        cols = _view(columns, np.uint32, (m, log_seg))
        o = _view(out, np.uint32, (k, lanes, 1, nw))
        s = None if not sig else _view(sig, np.uint32, (lanes, nw))
        for lst, (ptr, mask, n) in enumerate(((addrs_a, mask_a, n_a),
                                              (addrs_b, mask_b, n_b))[:k]):
            a = _view(ptr, np.uint32, (lanes, n))
            keep = (np.ones((lanes, n), bool) if not mask
                    else _view(mask, np.uint8, (lanes, n)).astype(bool))
            for lane in range(lanes):
                self._store(o[lst, lane], a[lane][keep[lane]], cols, m0, log_seg,
                            None if s is None else s[lane], or_out)
        return 0


@pytest.mark.parametrize("sig_bits,num_segments", [(2048, 64), (2**17, 1)])
def test_insert_spec_beyond_the_mask_cap_is_refused(monkeypatch, sig_bits, num_segments):
    """Specs past the kernels' old caps are taken on the card: every insert
    wrapper (id pair, bitmap pair in bank mode, B8a with an incoming
    signature) inserts a spec in passes of at most 512 column masks, one
    launch a pass, the later passes ORing into the words the earlier ones
    stored, and gives its plain version's result.  The spec fits one pass;
    the spec with twice the segments of twice the bits takes two when it
    has 640 masks."""
    lib = _InsertLib()
    for spec in (S.SignatureSpec(sig_bits=sig_bits, num_segments=num_segments),
                 S.SignatureSpec(sig_bits=2 * sig_bits, num_segments=2 * num_segments)):
        log_seg = spec.seg_bits.bit_length() - 1
        per = 512 // log_seg
        passes = [(min(per, spec.num_segments - m0), log_seg, m0, int(m0 > 0))
                  for m0 in range(0, spec.num_segments, per)]
        g = torch.Generator().manual_seed(sig_bits)
        ids = torch.randint(-2**31, 2**31 - 1, (2, 40), generator=g, dtype=torch.int32)
        valid = torch.rand((2, 40), generator=g) < 0.7
        ids_b, valid_b = ids[:, :25].contiguous(), valid[:, 5:30].contiguous()
        words = S.pack_words(torch.rand((2, 70), generator=g) < 0.3)
        words_b = S.pack_words(torch.rand((2, 70), generator=g) < 0.3)
        sig = S.pack_words(torch.rand((2, spec.sig_bits), generator=g) < 0.01)
        calls = (
            lambda: K.bloom_insert(spec, ids=ids, valid=valid, ids_b=ids_b, valid_b=valid_b),
            lambda: K.bloom_insert(spec, bitmap=words, bitmap_b=words_b, num_lines=70,
                                   num_regs=16),
            lambda: K8.bloom_insert_onehot(spec, sig, ids, valid, addrs_b=ids_b,
                                           mask_b=valid_b),
        )
        plain = [call() for call in calls]
        assert all(p[0].any() for p in plain)
        with monkeypatch.context() as mp:
            for mod in (K, K8):  # the tensors taken as CUDA tensors
                mp.setattr(mod, "_on_cpu", lambda *ts: False)
                mp.setattr(mod, "_lib", lambda: lib)
                mp.setattr(mod, "_stream", lambda t: 0)
            K.reset_launch_counts()
            K8.reset_launch_counts()
            lib.calls.clear()
            for call, want in zip(calls, plain):
                got = call()
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        names = ("bloom_insert_ids_launch", "bloom_insert_bitmap_launch",
                 "bloom_insert_onehot_launch")
        assert [c[0] for c in lib.calls] == [n for n in names for _ in passes]
        assert [c[3:] for c in lib.calls] == passes * 3
        assert all(c[1:3] == (2, 2) for c in lib.calls)  # two lists, two lanes
        assert K.launch_counts()["bloom_insert"] == 2 * len(passes)
        assert K8.launch_counts()["bloom_insert_onehot"] == len(passes)
    K.reset_launch_counts()
    K8.reset_launch_counts()


def test_insert_lane_cap_is_checked(monkeypatch):
    """Lanes sit on gridDim.y, which CUDA caps at 65,535; past it the
    kernels walk the lanes in a loop, so 65,536 lanes are one launch with
    the full lane count, as the plain version takes them."""
    spec = S.default_spec()
    fake = _FakeLib()
    _on_card(monkeypatch, K, fake)
    _on_card(monkeypatch, K8, fake)
    ids = torch.zeros((65_536, 1), dtype=torch.int32)
    valid = torch.ones((65_536, 1), dtype=torch.bool)
    K.reset_launch_counts()
    K8.reset_launch_counts()
    assert K.bloom_insert(spec, ids=ids, valid=valid).shape == (65_536, 1, spec.num_words)
    K.bloom_insert(spec, bitmap=ids, num_lines=32)
    K8.bloom_insert_onehot(spec, None, ids)
    lanes_at = {"bloom_insert_ids_launch": 7, "bloom_insert_bitmap_launch": 5,
                "bloom_insert_onehot_launch": 8}  # the lane count's argument
    assert [(name, args[lanes_at[name]]) for name, args in fake.calls] == \
        [(name, 65_536) for name in lanes_at]
    assert K.launch_counts()["bloom_insert"] == 2
    assert K8.launch_counts()["bloom_insert_onehot"] == 1
    K.reset_launch_counts()
    K8.reset_launch_counts()
