"""The five Bloom kernels' plain PyTorch versions (the CPU path of each
wrapper in repro_torch.kernels.bloom.bloom) held against repro's
primitives on the CPU, plus the wrappers' dispatch rule: plain version for
a CPU tensor, the kernel (or an error) for a CUDA tensor, never a
fallback."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.signatures import default_spec, hash_with_tables
from repro.core.signatures import _h3_tables_global as r_tables
from repro.sim import prep as RP
from repro.sim.trace import make_trace as r_make_trace
from repro_torch.core.signatures import default_spec as port_spec
from repro_torch.core.signatures import tables_tensor
from repro_torch.kernels.bloom import bloom as K
from repro_torch.sim import prep as TP
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


@pytest.fixture(scope="module")
def pair():
    """One small trace prepared by both packages (6409 lines: the last
    bitmap word has pad bits)."""
    rt = r_make_trace("pagerank", "arxiv", num_kernels=4)
    fields = {f.name: np.asarray(getattr(rt, f.name))
              for f in dataclasses.fields(rt)}
    return RP.prepare(rt), TP.prepare(trace_from_numpy(fields, "cpu"), device="cpu")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _bitmaps(n, lanes, density, seed):
    """The same random packed line bitmaps (zero pad bits) for both."""
    bits = np.random.default_rng(seed).random((lanes, n)) < density
    words = np.stack([np.asarray(RP.pack_bitmap(jnp.asarray(b))) for b in bits])
    return words, torch.from_numpy(words.view(np.int32))


def test_h3_hash_plain_equals_reference_tables():
    spec = default_spec()
    a = np.random.default_rng(0).integers(0, 2**32, 5000, dtype=np.uint64)
    a = a.astype(np.uint32)
    want = np.asarray(hash_with_tables(jnp.asarray(a),
                                       jnp.asarray(r_tables(spec)), spec))
    got = K.h3_hash(port_spec(), torch.from_numpy(a.view(np.int32)))
    assert got.dtype == torch.int32 and got.shape == (5000, 4)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert K.h3_hash(port_spec(), torch.zeros(0, dtype=torch.int32)).shape == (0, 4)


def test_insert_ids_equals_sig_bits_from_ids(pair):
    rtt, ttt = pair
    for ids, valid in (("pim_reads", "pim_r_valid"), ("pim_writes", "pim_w_valid"),
                       ("cpu_writes", "cpu_w_valid")):
        want = jax.vmap(lambda i, v: RP.sig_bits_from_ids(rtt, i, v))(
            getattr(rtt, ids), getattr(rtt, valid))
        # every window is one lane of the kernel's (L, A) input
        got = TP.sig_bits_from_ids(ttt, getattr(ttt, ids), getattr(ttt, valid))
        np.testing.assert_array_equal(_u32(got), np.asarray(want))


def test_invalid_slots_never_hash(pair):
    """A -1 slot marked invalid adds nothing; hashed it would set bits."""
    _, ttt = pair
    ids = torch.full((2, 8), -1, dtype=torch.int32)
    valid = torch.zeros((2, 8), dtype=torch.bool)
    assert not TP.sig_bits_from_ids(ttt, ids, valid).any()
    valid[1, 3] = True
    assert TP.sig_bits_from_ids(ttt, ids, valid)[1].any()


@pytest.mark.parametrize("density", [0.0, 0.002, 0.05])
def test_bank_mode_equals_bank_bits_from_bitmap(pair, density):
    rtt, ttt = pair
    rw, tw = _bitmaps(rtt.num_lines, 3, density, seed=int(density * 1e4))
    want = jax.vmap(lambda w: RP.bank_bits_from_bitmap(rtt, w))(jnp.asarray(rw))
    got = TP.bank_bits_from_bitmap(ttt, tw)
    assert got.shape == (3, 16, rtt.sig_words)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    single = TP.sig_bits_from_bitmap(ttt, tw)
    np.testing.assert_array_equal(
        _u32(single),
        np.asarray(jax.vmap(lambda w: RP.sig_bits_from_bitmap(rtt, w))(
            jnp.asarray(rw))))


def test_bank_mode_from_ids_equals_bank_from_bitmap(pair):
    """Id-list bank mode (register = id % 16) equals the bitmap bank of the
    same set of lines."""
    rtt, ttt = pair
    ids = torch.from_numpy(np.random.default_rng(4).choice(
        rtt.num_lines, size=(2, 64), replace=False).astype(np.int32))
    valid = torch.ones_like(ids, dtype=torch.bool)
    bank = K.bloom_insert(ttt.spec, ids=ids, valid=valid, num_regs=16)
    bitmap = TP.scatter_set(torch.zeros((2, ttt.num_line_words), dtype=torch.int32),
                            ids, valid, ttt.num_lines)
    np.testing.assert_array_equal(bank.numpy(),
                                  TP.bank_bits_from_bitmap(ttt, bitmap).numpy())


@pytest.mark.parametrize("density", [0.001, 0.02, 0.5])
def test_query_equals_members(pair, density):
    rtt, ttt = pair
    rw, tw = _bitmaps(rtt.num_lines, 4, density, seed=7)
    sig_r = jax.vmap(lambda i, v: RP.sig_bits_from_ids(rtt, i, v))(
        rtt.pim_reads[:4], rtt.pim_r_valid[:4])
    sig_t = TP.sig_bits_from_ids(ttt, ttt.pim_reads[:4], ttt.pim_r_valid[:4])
    want = jax.vmap(lambda w, s: RP.members(rtt, w, s))(jnp.asarray(rw), sig_r)
    got = TP.members(ttt, tw, sig_t)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    for lane in range(4):
        hits = TP.line_sig_hits(ttt, sig_t[lane])
        np.testing.assert_array_equal(
            TP.members_from_hits(tw[lane], hits).numpy(), got[lane].numpy())


def test_query_keeps_pad_bits_zero(pair):
    """Bits past num_lines stay zero even when the caller's words carry
    garbage there and a pad line's hash would hit."""
    _, ttt = pair
    n = ttt.num_lines
    assert n % 32
    words = torch.full((1, ttt.num_line_words), -1, dtype=torch.int32)
    sig = torch.full((1, ttt.sig_words), -1, dtype=torch.int32)  # every bit set
    got = TP.members(ttt, words, sig)
    bits = TP.unpack_bitmap(got, ttt.num_line_words * 32)
    assert bits[0, :n].all() and not bits[0, n:].any()


def _conflict_checks(pair, density):
    """The port's conflict check per lane — bank (bloom_insert) then
    bloom_intersect, any register — asserted equal to the reference's fused
    conflict_from_hits and its unfused conflict_any."""
    rtt, ttt = pair
    rw, tw = _bitmaps(rtt.num_lines, 6, density, seed=11)
    sig_r = jax.vmap(lambda i, v: RP.sig_bits_from_ids(rtt, i, v))(
        rtt.pim_reads[:6], rtt.pim_r_valid[:6])
    sig_t = TP.sig_bits_from_ids(ttt, ttt.pim_reads[:6], ttt.pim_r_valid[:6])
    got = TP.conflict_any(ttt, sig_t, TP.bank_bits_from_bitmap(ttt, tw))
    fused = jax.vmap(lambda w, s: RP.conflict_from_hits(
        rtt, w, RP.line_sig_hits(rtt, s)))(jnp.asarray(rw), sig_r)
    unfused = jax.vmap(lambda w, s: RP.conflict_any(
        rtt, s, RP.bank_bits_from_bitmap(rtt, w)))(jnp.asarray(rw), sig_r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(fused))
    np.testing.assert_array_equal(got.numpy(), np.asarray(unfused))
    for lane in range(6):
        hits = TP.line_sig_hits(ttt, sig_t[lane])
        assert bool(TP.conflict_from_hits(ttt, tw[lane], hits)) == bool(got[lane])
    return got


@pytest.mark.parametrize("density", [0.0005, 0.01, 0.2])
def test_intersect_any_equals_conflict_from_hits(pair, density):
    _conflict_checks(pair, density)


def test_conflict_check_sees_both_outcomes(pair):
    """The densities above cover conflicts and clean commits alike."""
    seen = {bool(v) for d in (0.0005, 0.2) for v in _conflict_checks(pair, d)}
    assert seen == {True, False}


def test_intersect_pairs_rows_with_their_lane():
    a = torch.zeros((4, 64), dtype=torch.int32)
    b = torch.zeros((2, 64), dtype=torch.int32)
    a[:, [0, 16, 32, 48]] = 1     # one bit in every segment
    b[0, [0, 16, 32, 48]] = 1     # lane 0 meets rows 0, 1
    b[1, [0, 16, 32]] = 1         # lane 1 misses segment 3
    assert K.bloom_intersect(a, b, 4).tolist() == [True, True, False, False]


class _FakeLib:
    """Stands in for the built CUDA library: records launches, returns a
    chosen cudaGetLastError() code."""

    def __init__(self, rc):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append(name)
            return self.rc
        return launch


def _kernel_calls():
    ids = torch.zeros((1, 4), dtype=torch.int32)
    valid = torch.ones((1, 4), dtype=torch.bool)
    words = torch.ones((1, 2), dtype=torch.int32)
    sig = torch.ones((1, 64), dtype=torch.int32)
    return {
        "h3_hash": lambda: K.h3_hash(port_spec(), ids[0].contiguous()),
        "bloom_insert": lambda: K.bloom_insert(port_spec(), ids=ids, valid=valid),
        "bloom_query": lambda: K.bloom_query(port_spec(), sig, words, 40),
        "bloom_intersect": lambda: K.bloom_intersect(sig, sig, 4),
        "bloom_detect_conflicts": lambda: K.bloom_detect_conflicts(
            port_spec(), sig, ids[0].contiguous()),
    }


@pytest.mark.parametrize("rc", [0, 700])
def test_cuda_path_launches_kernel_or_raises_never_plain(monkeypatch, rc):
    """With the tensors treated as CUDA tensors each wrapper goes to its
    kernel: a clean launch counts once, a launch error raises — neither
    touches the plain version."""
    fake = _FakeLib(rc)
    monkeypatch.setattr(K, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(K, "_lib", lambda: fake)
    monkeypatch.setattr(K, "_stream", lambda t: 0)
    monkeypatch.setattr(K, "_sm_count", lambda device: 132)  # no card to ask
    for name in K.KERNELS:
        monkeypatch.setattr(K, f"{name}_plain", None)  # any use would fail
    K.reset_launch_counts()
    for name, call in _kernel_calls().items():
        if rc:
            with pytest.raises(RuntimeError, match="CUDA error 700"):
                call()
        else:
            call()
    assert len(fake.calls) == len(K.KERNELS)
    want = 0 if rc else 1
    assert K.launch_counts() == {name: want for name in K.KERNELS}
    K.reset_launch_counts()


def test_cpu_path_counts_no_launch():
    K.reset_launch_counts()
    for call in _kernel_calls().values():
        call()
    assert K.launch_counts() == {name: 0 for name in K.KERNELS}


def test_wrappers_check_arguments():
    spec = port_spec()
    with pytest.raises(TypeError):
        K.h3_hash(spec, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        K.h3_hash(spec, torch.zeros((4, 4), dtype=torch.int32)[:, 0])
    with pytest.raises(TypeError):
        K.h3_hash(tables_tensor(spec, torch.device("cpu")), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        K.bloom_insert(port_spec())
    with pytest.raises(TypeError):
        K.bloom_insert(tables_tensor(spec, torch.device("cpu")),
                       ids=torch.zeros((1, 4), dtype=torch.int32),
                       valid=torch.ones((1, 4), dtype=torch.bool))
    with pytest.raises(ValueError):
        K.bloom_query(port_spec(), torch.zeros((1, 64), dtype=torch.int32),
                      torch.zeros((1, 3), dtype=torch.int32), 40)
    with pytest.raises(ValueError):
        K.bloom_intersect(torch.zeros((3, 64), dtype=torch.int32),
                          torch.zeros((2, 64), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        K.h3_hash(spec, torch.zeros(4, dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# bloom_detect_conflicts (B5): plain version against repro's oracle and its
# Pallas kernel in interpret mode, at tests/test_bloom_word_kernels.py's
# shapes; integer results, so exact equality
# ---------------------------------------------------------------------------


def _r_addrs(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n,), dtype=np.uint64).astype(np.uint32)


def _group_sigs(r_spec, num_groups, n=100):
    """(G, num_words) uint32 packed signatures of G seeded address sets,
    built by the reference's insert oracle."""
    from repro.core import signatures as RS
    from repro.kernels.bloom import ref as RR

    return np.stack([np.asarray(RR.bloom_insert_ref(
        r_spec, RS.empty_signature(r_spec), jnp.asarray(_r_addrs(n, seed=g))))
        for g in range(num_groups)])


@pytest.mark.parametrize("sig_bits,m", [(512, 2), (2048, 4), (4096, 8)])
@pytest.mark.parametrize("num_groups", [2, 4, 8])
def test_detect_conflicts_plain_equals_reference(sig_bits, m, num_groups):
    from repro.core.signatures import SignatureSpec as RSpec
    from repro.kernels.bloom import bloom as RK
    from repro.kernels.bloom import ref as RR
    from repro_torch.core.signatures import SignatureSpec as TSpec
    from repro_torch.kernels.bloom import ops as TO
    from repro_torch.kernels.bloom import ref as TR

    r_spec, t_spec = RSpec(sig_bits, m), TSpec(sig_bits, m)
    sigs = _group_sigs(r_spec, num_groups)
    probes = np.concatenate([_r_addrs(100, seed=0)[:50], _r_addrs(78, seed=1234)])
    want = np.asarray(RR.bloom_detect_conflicts_ref(
        r_spec, jnp.asarray(sigs), jnp.asarray(probes)))
    pallas = np.asarray(RK.bloom_detect_conflicts_pallas(
        r_spec, jnp.asarray(sigs), jnp.asarray(probes), interpret=True, block_n=64))
    np.testing.assert_array_equal(pallas, want)
    t_sigs = torch.from_numpy(sigs.view(np.int32))
    t_probes = torch.from_numpy(probes.view(np.int32))
    plain = K.bloom_detect_conflicts_plain(t_spec, t_sigs, t_probes)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(TO.bloom_detect_conflicts(t_spec, t_sigs, t_probes).numpy(), want)
    np.testing.assert_array_equal(TR.bloom_detect_conflicts_ref(t_spec, t_sigs, t_probes).numpy(), want)
    # every group's own addresses are counted (no false negatives)
    own = TO.bloom_detect_conflicts(t_spec, t_sigs,
                                    torch.from_numpy(_r_addrs(100, seed=0).view(np.int32)))
    assert int(own.min()) >= 1


def test_detect_conflicts_ops_takes_any_integer_ids():
    """The signature-level wrapper takes int64 ids (its low 32 bits) and an
    empty batch, as the reference's ops wrapper does."""
    from repro.core.signatures import SignatureSpec as RSpec
    from repro_torch.kernels.bloom import ops as TO

    spec = port_spec()
    sigs = torch.from_numpy(_group_sigs(RSpec(), 4).view(np.int32))
    ids = torch.from_numpy(_r_addrs(64, seed=0).astype(np.int64))
    want = TO.bloom_detect_conflicts(spec, sigs, ids.to(torch.int32))
    np.testing.assert_array_equal(TO.bloom_detect_conflicts(spec, sigs, ids).numpy(),
                                  want.numpy())
    assert TO.bloom_detect_conflicts(spec, sigs, ids[:0]).shape == (0,)
    with pytest.raises(ValueError, match="packed words"):
        TO.bloom_detect_conflicts(spec, sigs[:, :32].contiguous(), ids)


def test_detect_conflicts_checks_arguments():
    spec = port_spec()
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="1 to 16"):
        K.bloom_detect_conflicts(spec, torch.zeros((17, 64), dtype=torch.int32), ids)
    with pytest.raises(TypeError):
        K.bloom_detect_conflicts(spec, torch.zeros((4, 64), dtype=torch.int64), ids)
    with pytest.raises(ValueError):
        K.bloom_detect_conflicts(spec, torch.zeros((4, 64), dtype=torch.int32),
                                 ids.to("meta"))
    with pytest.raises(ValueError, match=r"want \(G, 64\)"):
        K.bloom_detect_conflicts(spec, torch.zeros((4, 32), dtype=torch.int32), ids)
