"""``h3_hash`` (B1) and ``bloom_detect_conflicts`` (B5) on the CPU: their
plain versions against ``repro``'s ``_h3_hash_block`` and
``bloom_detect_conflicts_pallas`` (interpret mode); the packed byte tables
both kernels hash with, in their plain PyTorch arithmetic, against the
byte-sliced tables; specs past the kernels' old cap (64 segments, 40 to
72 address bits, of which a 32-bit line id meets only the first 32) and
B5's route; and the kernel path through a stand-in library that runs the
packed-table arithmetic on the launch's own pointers, which counts one
``h3_hash`` launch a ``prepare`` and one ``h3_hash`` and one
``bloom_detect_conflicts`` launch a LazySync step.  Integer results, so
every comparison is exact."""

from __future__ import annotations

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import signatures as RS
from repro.kernels.bloom import bloom as RK
from repro.kernels.bloom import ref as RR
from repro_torch.configs import get_smoke_config
from repro_torch.core import signatures as S
from repro_torch.core.lazy_sync import LazyEmbed, LazySyncConfig, init_state
from repro_torch.kernels.bloom import bloom as K
from repro_torch.kernels.bloom import ops as TO
from repro_torch.sim import prep as TP
from repro_torch.sim.trace import make_trace

# (sig_bits, num_segments, addr_bits): the paper's registers, then other
# geometries: two 9-bit segments of a word, 8 segments over two words an
# entry, 32 segments over four, and two byte slices.
GEOMETRIES = [(2048, 4, 32), (1024, 2, 32), (4096, 8, 32), (2048, 32, 32), (4096, 8, 9)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module's small CPU ops, so parallel test
    workers do not oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _specs(sig_bits, num_segments, addr_bits):
    return (S.SignatureSpec(sig_bits, num_segments, addr_bits),
            RS.SignatureSpec(sig_bits, num_segments, addr_bits))


def _addrs(n: int, seed: int) -> np.ndarray:
    """n seeded uint32 addresses over the full range, led by the sign-bit
    and extreme ones."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, size=(n,), dtype=np.uint64).astype(np.uint32)
    edge = np.array([2**31, 2**32 - 1, 0, 2**31 + 1], np.uint32)
    a[:min(n, 4)] = edge[:min(n, 4)]
    return a


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32).copy())


# ---------------------------------------------------------------------------
# Plain versions against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=str)
@pytest.mark.parametrize("n", [0, 1, 192, 16_384])
def test_h3_hash_plain_equals_reference_block(geometry, n):
    spec, r_spec = _specs(*geometry)
    a = _addrs(n, seed=n + sum(geometry))
    want = np.asarray(RK._h3_hash_block(jnp.asarray(a), RK._tables_operand(r_spec), r_spec))
    got = K.h3_hash(spec, _t(a))                  # a CPU tensor: the plain version
    assert got.dtype == torch.int32 and got.shape == (n, spec.num_segments)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(K.h3_hash_plain(spec, _t(a)), got)
    assert torch.equal(S.hash_positions(spec, _t(a)), got)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=str)
def test_packed_table_arithmetic_equals_byte_sliced_tables(geometry):
    """The kernels' arithmetic in plain PyTorch: XOR an address's packed
    entries, cut each segment's field from its word -> the positions of the
    byte-sliced tables, for every geometry and the full address range."""
    spec, _ = _specs(*geometry)
    log_seg = spec.seg_bits.bit_length() - 1
    per = 64 // log_seg
    ptab = S.packed_tables(spec)
    assert ptab.dtype == np.uint64 and not ptab.flags.writeable
    assert ptab.shape == (spec.num_byte_slices, 256, -(-spec.num_segments // per))
    tabs = spec.h3_tables                          # (S, 256, M), unfolded
    for m in range(spec.num_segments):
        field = (ptab[:, :, m // per] >> np.uint64((m % per) * log_seg)) & np.uint64(
            spec.seg_bits - 1)
        np.testing.assert_array_equal(field, tabs[:, :, m])
    a = _t(_addrs(20_000, seed=7))
    assert torch.equal(S.hash_positions_packed(spec, a),
                       S.hash_with_tables(a, S.tables_tensor(spec, torch.device("cpu"))))
    t = S.packed_tables_tensor(spec, torch.device("cpu"))
    assert t.dtype == torch.int64 and np.array_equal(t.numpy().view(np.uint64), ptab)


def test_paper_geometry_packs_one_word_an_entry():
    ptab = S.packed_tables(S.default_spec())
    assert ptab.shape == (4, 256, 1) and ptab.nbytes == 8192
    assert int(ptab.max()) < 2**36                 # 4 segments of 9 bits


def _dense_sigs(spec, groups, seed):
    """(G, num_words) packed signatures dense enough that an address is in
    a given group with probability ~0.24, so counts 0..G all occur."""
    density = 0.7 ** (4 / spec.num_segments)
    bits = np.random.default_rng(seed).random((groups, spec.sig_bits)) < density
    return np.packbits(bits, axis=-1, bitorder="little").view("<u4")


@pytest.mark.parametrize("geometry", GEOMETRIES[:3], ids=str)
@pytest.mark.parametrize("groups", [1, 4, 16])
@pytest.mark.parametrize("n", [0, 1, 192, 16_384])
def test_detect_conflicts_plain_equals_pallas(geometry, groups, n):
    spec, r_spec = _specs(*geometry)
    sigs = _dense_sigs(spec, groups, seed=groups + sum(geometry))
    a = _addrs(n, seed=n + groups)
    if n:
        want = np.asarray(RK.bloom_detect_conflicts_pallas(
            r_spec, jnp.asarray(sigs), jnp.asarray(a), interpret=True))
    else:  # the Pallas grid needs one block
        want = np.asarray(RR.bloom_detect_conflicts_ref(r_spec, jnp.asarray(sigs),
                                                        jnp.asarray(a)))
    t_sigs = torch.from_numpy(sigs.view(np.int32))
    got = K.bloom_detect_conflicts(spec, t_sigs, _t(a))   # CPU: the plain version
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(K.bloom_detect_conflicts_plain(spec, t_sigs, _t(a)), got)
    assert torch.equal(TO.bloom_detect_conflicts(spec, t_sigs, _t(a)), got)
    if n == 16_384:  # the counts vary (all of 0..G where G <= 4)
        assert len(np.unique(want)) >= min(groups + 1, 5)


# ---------------------------------------------------------------------------
# The kernel path, through stand-in libraries
# ---------------------------------------------------------------------------


def _view(ptr: int, dtype, shape) -> np.ndarray:
    """A writable numpy view of ``shape`` elements at host address ``ptr``."""
    count = int(np.prod(shape)) * np.dtype(dtype).itemsize
    return np.frombuffer((ctypes.c_char * count).from_address(ptr), dtype=dtype).reshape(
        shape)


class _PackedLib:
    """Stands in for the built library: runs the packed-table arithmetic of
    ``h3_hash_launch`` and ``bloom_detect_conflicts_launch`` in numpy on the
    host memory the launch's pointers name (the tensors are CPU tensors
    taken as CUDA ones), so the result checks what the wrapper passed.
    Records every launch; any other entry point fails."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _positions(addrs, ptab, n, s, m, log_seg):
        per = 64 // log_seg
        a = _view(addrs, np.uint32, (n,)).astype(np.uint64)
        tab = _view(ptab, np.uint64, (s, 256, -(-m // per)))
        h = tab[0][a & np.uint64(0xFF)]
        for k in range(1, s):
            h = h ^ tab[k][(a >> np.uint64(8 * k)) & np.uint64(0xFF)]
        seg = np.arange(m)
        field = (h[:, seg // per] >> (seg % per * log_seg).astype(np.uint64)) & np.uint64(
            (1 << log_seg) - 1)
        return (seg.astype(np.uint64) << np.uint64(log_seg)) | field

    def h3_hash_launch(self, addrs, ptab, out, n, s, m, log_seg, stream):
        self.calls.append(("h3_hash_launch", n, s, m, log_seg))
        _view(out, np.uint32, (n, m))[:] = self._positions(addrs, ptab, n, s, m, log_seg)
        return 0

    def bloom_detect_conflicts_launch(self, sigs, addrs, ptab, out, n, g, nw, s, m,
                                      log_seg, transposed, sms, stream):
        self.calls.append(("bloom_detect_conflicts_launch", n, g, nw, s, m, log_seg,
                           transposed, sms))
        pos = self._positions(addrs, ptab, n, s, m, log_seg)
        words = _view(sigs, np.uint32, (g, nw))[:, pos >> np.uint64(5)]  # (G, N, M)
        member = ((words >> (pos & np.uint64(31)).astype(np.uint32)) & 1).all(-1)
        _view(out, np.int32, (n,))[:] = member.sum(0)
        return 0


def test_stand_in_launchers_take_the_declared_arguments():
    """The stand-in's launchers take as many arguments as the ctypes
    declarations pass to the built library."""
    import inspect

    for name in ("h3_hash_launch", "bloom_detect_conflicts_launch"):
        params = inspect.signature(getattr(_PackedLib(), name)).parameters
        assert len(params) == len(K._SIGNATURES[name]), name


SMS = 132  # the stand-in card's SM count


def _on_card(monkeypatch, lib):
    monkeypatch.setattr(K, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(K, "_lib", lambda: lib)
    monkeypatch.setattr(K, "_stream", lambda t: 0)
    monkeypatch.setattr(K, "_sm_count", lambda device: SMS)


@pytest.mark.parametrize("geometry", GEOMETRIES + [(2**17, 4, 32)], ids=str)
def test_kernel_path_passes_what_the_packed_arithmetic_needs(monkeypatch, geometry):
    """Through the stand-in, each wrapper's launch gives the plain version's
    result: the pointers, the geometry and B5's route flag are what the
    launchers read, and B5 gets the card's SM count for its one-wave grid.
    Each launch counts once, on B5's route."""
    spec, _ = _specs(*geometry)
    a = _t(_addrs(3000, seed=1))
    sigs = torch.from_numpy(_dense_sigs(spec, 4, seed=2).view(np.int32))
    want_pos = K.h3_hash_plain(spec, a)
    want_hits = K.bloom_detect_conflicts_plain(spec, sigs, a)
    lib = _PackedLib()
    _on_card(monkeypatch, lib)
    K.reset_launch_counts()
    assert torch.equal(K.h3_hash(spec, a), want_pos)
    assert torch.equal(K.bloom_detect_conflicts(spec, sigs, a), want_hits)
    route = "direct" if spec.sig_bits > 2**15 else "transposed"
    assert K.detect_route(spec) == route
    assert lib.calls[1][-2:] == (int(route == "transposed"), SMS)
    assert K.launch_counts()["h3_hash"] == K.launch_counts()["bloom_detect_conflicts"] == 1
    assert K.detect_route_counts() == {r: int(r == route) for r in K.DETECT_ROUTES}
    K.reset_launch_counts()
    assert K.detect_route_counts() == dict.fromkeys(K.DETECT_ROUTES, 0)


@pytest.mark.parametrize("sig_bits,num_segments,addr_bits", [(2048, 64, 32), (2048, 4, 40)])
def test_spec_beyond_the_cap_is_refused(monkeypatch, sig_bits, num_segments, addr_bits):
    """More than 32 segments, or addresses of more than 4 byte slices, were
    past the packed-table kernels' old cap; both wrappers now launch them
    and give the plain result.  M = 64 takes several words an entry; a spec
    of 40 address bits launches with 4 of its 5 byte slices (a line id's
    fifth byte is 0, whose entry is 0), which the plain version, hashing
    all 5, agrees with."""
    spec = S.SignatureSpec(sig_bits, num_segments, addr_bits)
    a = _t(_addrs(64, seed=3))
    sigs = torch.full((2, spec.num_words), -1, dtype=torch.int32)
    sigs[1, ::3] = 0
    want_pos = K.h3_hash(spec, a)
    want_hits = K.bloom_detect_conflicts(spec, sigs, a)
    assert want_pos.shape == (64, num_segments) and 0 < int(want_hits.sum()) < 128
    lib = _PackedLib()
    _on_card(monkeypatch, lib)
    assert torch.equal(K.h3_hash(spec, a), want_pos)
    assert torch.equal(K.bloom_detect_conflicts(spec, sigs, a), want_hits)
    assert lib.calls[0][2:5] == (4, num_segments, spec.seg_bits.bit_length() - 1)
    assert lib.calls[1][4:6] == (4, num_segments)
    assert spec.num_byte_slices == (5 if addr_bits == 40 else 4)


@pytest.mark.parametrize("addr_bits", [33, 40, 64, 72])
def test_address_bits_past_32_meet_no_set_bit(addr_bits):
    """H3 rows past bit 31 never meet a set bit of a 32-bit line id: for
    specs of more address bits, the byte-sliced tables over every slice,
    the packed tables read over their first 4 slices (what the kernels
    read), the parity form, the xor-fold and repro's hash agree."""
    spec, r_spec = _specs(2048, 4, addr_bits)
    a = _addrs(3000, seed=addr_bits)
    t = _t(a)
    want = np.asarray(RS.hash_positions(r_spec, jnp.asarray(a)))
    tables = S.hash_with_tables(t, S.tables_tensor(spec, torch.device("cpu")))
    np.testing.assert_array_equal(tables.numpy().view(np.uint32), want)
    assert torch.equal(S.hash_positions_packed(spec, t), tables)
    assert torch.equal(S.hash_positions_parity(spec, t), tables)
    assert torch.equal(S.hash_positions_xorfold(spec, t), tables)
    ptab = S.packed_tables(spec)
    assert ptab.shape[0] == spec.num_byte_slices > 4
    assert not ptab[4:, 0].any()  # byte 0 of every slice past the fourth hashes to 0
    s4 = _PackedLib._positions(t.data_ptr(), S.packed_tables_tensor(
        spec, torch.device("cpu")).data_ptr(), t.shape[0], 4, 4, 9)
    np.testing.assert_array_equal(s4.astype(np.uint32), want)


def test_largest_specs_under_the_cap_are_taken(monkeypatch):
    """32 segments (four words an entry) and 2^26-bit segments (two a
    word) launch, and give the plain result."""
    lib = _PackedLib()
    a = _t(_addrs(500, seed=4))
    specs = [S.SignatureSpec(2048, 32), S.SignatureSpec(2**27, 2)]
    want = [K.h3_hash_plain(spec, a) for spec in specs]
    _on_card(monkeypatch, lib)
    for spec, w in zip(specs, want):
        assert torch.equal(K.h3_hash(spec, a), w)
    assert [c[3:] for c in lib.calls] == [(32, 6), (2, 26)]


@pytest.mark.parametrize("reader,entry,builds", [
    ("hash_attributes", "h3_hash_attributes", ("paper", "any")),
    ("detect_attributes", "bloom_detect_conflicts_attributes", ("paper", "any", "direct")),
])
def test_attribute_readers_name_every_build(monkeypatch, reader, entry, builds):
    """Each reader takes three ints a build (registers, local bytes, static
    shared bytes) from its entry point, in the order the library writes
    them; an error code from the entry point raises."""
    class _AttrLib:
        rc = 0

        def __getattr__(self, name):
            assert name == entry, name

            def fill(out):
                ints = (ctypes.c_int * (3 * len(builds))).from_address(out)
                ints[:] = list(range(1, 3 * len(builds) + 1))
                return self.rc
            return fill

    lib = _AttrLib()
    monkeypatch.setattr(K, "_lib", lambda: lib)
    got = getattr(K, reader)()
    assert list(got) == list(builds)
    for i, b in enumerate(builds):
        assert got[b] == {"registers": 3 * i + 1, "local_bytes": 3 * i + 2,
                          "static_smem_bytes": 3 * i + 3}
    lib.rc = 98
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        getattr(K, reader)()


def test_prepare_and_a_lazysync_step_launch_once_each(monkeypatch):
    """Through the stand-in: ``prepare`` makes one ``h3_hash`` launch; a
    LazySync step one ``h3_hash`` (the signatures) and one
    ``bloom_detect_conflicts`` (the conflict test), and gives the CPU
    path's step bit for bit."""
    trace = make_trace("pagerank", "arxiv", num_kernels=2, device="cpu")
    want_tt = TP.prepare(trace, device="cpu")
    mcfg = get_smoke_config("qwen3_4b")
    cfg = LazySyncConfig(num_groups=4, commit_interval=4, max_reconcile_rows=64)
    emb = LazyEmbed(mcfg, cfg)
    params = emb.init(torch.Generator().manual_seed(0))
    state = init_state(cfg, mcfg.vocab, "cpu")
    rng = np.random.default_rng(0)
    touched = torch.from_numpy(rng.integers(0, mcfg.vocab, (4, 32)).astype(np.int32))
    grads = torch.zeros((4, mcfg.vocab, mcfg.d_model))
    grads[:, :64] = torch.from_numpy(rng.normal(size=(4, 64, mcfg.d_model)).astype(
        np.float32))
    want = emb.sync_step(params, state, touched, grads)

    lib = _PackedLib()
    _on_card(monkeypatch, lib)
    K.reset_launch_counts()
    tt = TP.prepare(trace, device="cpu")
    assert K.launch_counts()["h3_hash"] == 1
    assert K.launch_counts()["bloom_detect_conflicts"] == 0
    for f in dataclasses.fields(tt):
        got_f, want_f = getattr(tt, f.name), getattr(want_tt, f.name)
        assert (torch.equal(got_f, want_f) if isinstance(got_f, torch.Tensor)
                else got_f == want_f), f.name
    K.reset_launch_counts()
    got = emb.sync_step(params, state, touched, grads)
    assert K.launch_counts()["h3_hash"] == 1
    assert K.launch_counts()["bloom_detect_conflicts"] == 1
    assert K.detect_route_counts() == {"transposed": 1, "direct": 0}
    assert [c[0] for c in lib.calls] == ["h3_hash_launch", "h3_hash_launch",
                                         "bloom_detect_conflicts_launch"]
    for part_got, part_want in zip(got, want):
        for k in part_want:
            assert torch.equal(torch.as_tensor(part_got[k]), torch.as_tensor(part_want[k])), k
    K.reset_launch_counts()
