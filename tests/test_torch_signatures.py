"""repro_torch.core.signatures and the signature-level Bloom API held against
repro's on the CPU: the same H3 family, hash positions, packed words and
register semantics, bit for bit (packed words compared as uint32)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import signatures as RS
from repro.kernels.bloom import bloom as RK
from repro.kernels.bloom import ref as RR
from repro_torch.core import signatures as TS
from repro_torch.kernels.bloom import ops as TO
from repro_torch.kernels.bloom import ref as TR


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's small CPU tensor ops on one thread: with several
    test workers on one host, torch's default thread pool per worker
    oversubscribes the cores and slows every worker down."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SPECS = {
    "paper_2k_m4": (2048, 4),
    "small_1k_m2": (1024, 2),
    "big_8k_m4": (8192, 4),
}


def _specs(name):
    bits, m = SPECS[name]
    return (RS.SignatureSpec(sig_bits=bits, num_segments=m),
            TS.SignatureSpec(sig_bits=bits, num_segments=m))


def _u32(x) -> np.ndarray:
    """Either package's packed words as uint32 bit patterns."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.int64).astype(np.uint32) if a.dtype != np.uint32 else a


def _addrs(n, seed, top_bit=True):
    """Random 32-bit line addresses, a quarter with the top bit set."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**31, size=n, dtype=np.int64)
    if top_bit:
        a[::4] |= 1 << 31
    return a.astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


def _sig(spec_r, spec_t, seed, n=40):
    """The same random signature in both packages (built by insertion)."""
    a = _addrs(n, seed)
    r = RR.bloom_insert_ref(spec_r, RS.empty_signature(spec_r), jnp.asarray(a))
    t = TS.insert(spec_t, TS.empty_signature(spec_t, "cpu"), _t(a))
    return r, t


@pytest.mark.parametrize("name", list(SPECS))
def test_h3_matrix_and_tables_equal_reference(name):
    r, t = _specs(name)
    np.testing.assert_array_equal(t.h3_matrix, r.h3_matrix)
    np.testing.assert_array_equal(t.h3_tables, r.h3_tables)
    np.testing.assert_array_equal(TS._h3_tables_global(t),
                                  RS._h3_tables_global(r))
    assert (t.seg_bits, t.num_words, t.words_per_seg, t.num_byte_slices) == \
        (r.seg_bits, r.num_words, r.words_per_seg, r.num_byte_slices)


def test_spec_checks_match_reference():
    for bits, m in ((2048, 3), (96 * 4, 4)):
        with pytest.raises(ValueError):
            RS.SignatureSpec(sig_bits=bits, num_segments=m)
        with pytest.raises(ValueError):
            TS.SignatureSpec(sig_bits=bits, num_segments=m)
    assert TS.default_spec() is TS.default_spec()
    assert TS.default_spec() == TS.SignatureSpec()


@pytest.mark.parametrize("name", list(SPECS))
def test_hash_positions_equal_reference_incl_top_bit(name):
    r, t = _specs(name)
    a = _addrs(3000, seed=7)
    want = np.asarray(RS.hash_positions(r, jnp.asarray(a)))
    got = TS.hash_positions(t, _t(a))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  want.astype(np.int64))
    np.testing.assert_array_equal(
        TS.hash_positions_xorfold(t, _t(a)).numpy(), got.numpy())
    # int32-typed addresses (the kernels' input type) hash the same bits
    np.testing.assert_array_equal(
        TS.hash_positions(t, torch.from_numpy(a.view(np.int32))).numpy(),
        got.numpy())


@pytest.mark.parametrize("sig_bits,m", [(2048, 4), (1024, 2), (8192, 8)])
def test_pack_unpack_equal_reference(sig_bits, m):
    r = RS.SignatureSpec(sig_bits=sig_bits, num_segments=m)
    t = TS.SignatureSpec(sig_bits=sig_bits, num_segments=m)
    bits = np.random.default_rng(sig_bits).random(sig_bits) < 0.3
    bits[31] = bits[-1] = True  # sign bits of the int32 words
    want = np.asarray(RS.pack_bits(r, jnp.asarray(bits)))
    got = TS.pack_bits(t, torch.from_numpy(bits))
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(TS.unpack_bits(t, got).numpy(), bits)
    assert int(TS.popcount(got)) == int(RS.popcount(jnp.asarray(want))) \
        == int(bits.sum())
    assert float(TS.saturation(t, got)) == pytest.approx(
        float(RS.saturation(r, jnp.asarray(want))))


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("n", [7, 300])
def test_insert_equals_ref_and_pallas(name, n):
    r, t = _specs(name)
    a = _addrs(n, seed=n)
    sig0 = RS.empty_signature(r)
    want_ref = np.asarray(RR.bloom_insert_ref(r, sig0, jnp.asarray(a)))
    if name == "paper_2k_m4":
        np.testing.assert_array_equal(want_ref, np.asarray(RK.bloom_insert_pallas(
            r, sig0, jnp.asarray(a), interpret=True, block_n=64)))
    got = TO.bloom_insert(t, TS.empty_signature(t, "cpu"), _t(a))
    np.testing.assert_array_equal(_u32(got), want_ref)
    np.testing.assert_array_equal(
        _u32(TR.bloom_insert_ref(t, TS.empty_signature(t, "cpu"), _t(a))),
        want_ref)


@pytest.mark.parametrize("name", list(SPECS))
def test_masked_insert_and_accumulate_equal_reference(name):
    r, t = _specs(name)
    a = _addrs(90, seed=5)
    mask = np.random.default_rng(1).integers(0, 2, size=90).astype(bool)
    r_sig, t_sig = _sig(r, t, seed=3)
    want = np.asarray(RK.bloom_insert_pallas(
        r, r_sig, jnp.asarray(a), jnp.asarray(mask), interpret=True, block_n=32))
    got = TO.bloom_insert(t, t_sig, _t(a), torch.from_numpy(mask))
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(
        _u32(TS.insert(t, t_sig, _t(a), torch.from_numpy(mask))), want)


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("n", [33])
def test_query_equals_ref_and_pallas(name, n):
    r, t = _specs(name)
    r_sig, t_sig = _sig(r, t, seed=11, n=200)
    probe = np.concatenate([_addrs(n, seed=11, top_bit=True)[: n // 2],
                            _addrs(n - n // 2, seed=99)])
    want = np.asarray(RR.bloom_query_ref(r, r_sig, jnp.asarray(probe)))
    if name == "paper_2k_m4":
        np.testing.assert_array_equal(want, np.asarray(RK.bloom_query_pallas(
            r, r_sig, jnp.asarray(probe), interpret=True, block_n=64)))
    np.testing.assert_array_equal(TO.bloom_query(t, t_sig, _t(probe)).numpy(), want)
    np.testing.assert_array_equal(TS.query(t, t_sig, _t(probe)).numpy(), want)
    np.testing.assert_array_equal(TR.bloom_query_ref(t, t_sig, _t(probe)).numpy(),
                                  want)


@pytest.mark.parametrize("name", list(SPECS))
def test_intersect_equals_ref_and_pallas(name):
    r, t = _specs(name)
    rng = np.random.default_rng(len(name))
    # sparse to dense images: empty segments, single hits, saturated words
    dens = np.array([0.0005, 0.002, 0.01, 0.05, 0.3, 0.9])[:, None, None]
    a = _u32(TS.pack_words(torch.from_numpy(
        rng.random((6, t.num_words, 32)) < dens).reshape(6, -1)))
    b = _u32(TS.pack_words(torch.from_numpy(
        rng.random((6, t.num_words, 32)) < dens[::-1]).reshape(6, -1)))
    ra, rb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32))
    want = np.asarray(RR.bloom_intersect_ref(r, ra, rb))
    np.testing.assert_array_equal(
        want, np.asarray(RK.bloom_intersect_pallas(r, ra, rb, interpret=True)))
    np.testing.assert_array_equal(TO.bloom_intersect(t, ta, tb).numpy(), want)
    np.testing.assert_array_equal(TR.bloom_intersect_ref(t, ta, tb).numpy(), want)
    for i in range(ta.shape[0]):
        assert bool(TS.intersect_nonempty(t, ta[i], tb[i])) == bool(want[i])
    np.testing.assert_array_equal(_u32(TS.intersect(ta, tb)),
                                  np.asarray(RS.intersect(ra, rb)))
    assert bool(TS.bank_intersect_nonempty(t, ta, tb[2])) == \
        bool(RS.bank_intersect_nonempty(r, ra, rb[2]))


def test_bank_round_robin_equals_reference():
    r, t = _specs("paper_2k_m4")
    a = _addrs(50, seed=8)
    mask = np.random.default_rng(2).random(50) < 0.6
    rb, rc = RS.insert_bank_round_robin(r, RS.empty_bank(r, 16), jnp.asarray(a),
                                        5, jnp.asarray(mask))
    tb, tc = TS.insert_bank_round_robin(t, TS.empty_bank(t, 16, "cpu"), _t(a),
                                        5, torch.from_numpy(mask))
    np.testing.assert_array_equal(_u32(tb), np.asarray(rb))
    assert int(tc) == int(rc)


def test_expected_fp_rate_equals_reference():
    r, t = _specs("paper_2k_m4")
    for n in (0, 10, 250, 5000):
        assert TS.expected_membership_fp_rate(t, n) == \
            RS.expected_membership_fp_rate(r, n)


def test_u32_helpers_round_trip_sign_bit():
    x = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    i = TS.u32_to_i32(x)
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy().view(np.uint32), x.numpy())
    np.testing.assert_array_equal(TS.as_u32(i).numpy(), x.numpy())
    np.testing.assert_array_equal(TS.popcount_per_word(i).numpy(),
                                  [0, 1, 31, 1, 32])
