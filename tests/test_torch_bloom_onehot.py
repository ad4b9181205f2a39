"""The seed one-hot Bloom kernels' plain PyTorch versions (the CPU path of
each wrapper in repro_torch.kernels.bloom.onehot) against repro's Pallas
kernels ``bloom_insert_pallas_onehot`` / ``bloom_query_pallas_onehot`` in
interpret mode, over the reference's geometries (sig_bits in {512, 2048,
4096} x M in {2, 4, 8}, tests/test_bloom_word_kernels.py), with random
masks, an all-false mask and ragged N; against the port's word-level
plain versions (B2, B3); and the wrappers' dispatch rule.  Integer
results, so the tolerance is exact equality."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import signatures as RS
from repro.kernels.bloom import bloom as RK
from repro_torch.core import signatures as S
from repro_torch.kernels.bloom import bloom as K
from repro_torch.kernels.bloom import onehot as K8

GEOMETRIES = [(sig_bits, m) for sig_bits in (512, 2048, 4096) for m in (2, 4, 8)
              if sig_bits % (32 * m) == 0]
N = 300          # ragged against the reference's block of 64 (and the kernel's)
BLOCK_N = 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's small CPU tensor ops on one thread: with several
    test workers on one host, torch's default thread pool per worker
    oversubscribes the cores and slows every worker down."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _addrs(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n,), dtype=np.uint64).astype(np.uint32)


def _mask(kind, n, seed):
    if kind == "all_false":
        return np.zeros((n,), dtype=bool)
    return np.random.default_rng(seed).integers(0, 2, size=(n,)).astype(bool)


def _t(a: np.ndarray) -> torch.Tensor:
    """A numpy row as a (1, n) tensor (uint32 read as int32 bits)."""
    a = a.view(np.int32) if a.dtype == np.uint32 else a
    return torch.from_numpy(a.copy())[None]


def _specs(sig_bits, m):
    return (RS.SignatureSpec(sig_bits=sig_bits, num_segments=m),
            S.SignatureSpec(sig_bits=sig_bits, num_segments=m))


@functools.lru_cache(maxsize=None)
def _r_insert(sig_bits, m):
    """repro's seed insert kernel for one geometry, compiled once for the
    mask kinds (an unmasked call is the all-true mask, as the reference
    wrapper itself fills it)."""
    r_spec, _ = _specs(sig_bits, m)
    return jax.jit(lambda sig, addrs, mask: RK.bloom_insert_pallas_onehot(
        r_spec, sig, addrs, mask, block_n=BLOCK_N, interpret=True))


@pytest.mark.parametrize("sig_bits,m", GEOMETRIES)
@pytest.mark.parametrize("mask_kind", ["random", "all_false", "unmasked"])
def test_insert_plain_equals_pallas_onehot(sig_bits, m, mask_kind):
    _, spec = _specs(sig_bits, m)
    addrs = _addrs(N, sig_bits + m)
    mask = None if mask_kind == "unmasked" else _mask(mask_kind, N, m)
    sig0 = np.zeros((spec.num_words,), np.uint32)
    sig0[::3] = 0x80000001  # an incoming signature with bits already set
    want = _r_insert(sig_bits, m)(jnp.asarray(sig0), jnp.asarray(addrs), jnp.asarray(
        np.ones((N,), bool) if mask is None else mask))
    got = K8.bloom_insert_onehot(spec, _t(sig0), _t(addrs),
                                 None if mask is None else _t(mask))
    assert got.dtype == torch.int32 and got.shape == (1, spec.num_words)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), np.asarray(want))
    if mask_kind == "all_false":
        np.testing.assert_array_equal(got[0].numpy().view(np.uint32), sig0)


@pytest.mark.parametrize("sig_bits,m", GEOMETRIES)
def test_query_plain_equals_pallas_onehot(sig_bits, m):
    r_spec, spec = _specs(sig_bits, m)
    inserted = _addrs(N, sig_bits)
    sig = np.asarray(RS.insert(r_spec, RS.empty_signature(r_spec), jnp.asarray(inserted)))
    probes = np.concatenate([inserted[:100], _addrs(N - 100, m + 7)])
    want = np.asarray(RK.bloom_query_pallas_onehot(
        r_spec, jnp.asarray(sig), jnp.asarray(probes), block_n=BLOCK_N, interpret=True))
    bits = S.unpack_words(_t(sig), spec.sig_bits)
    got = K8.bloom_query_onehot(spec, bits, _t(probes))
    assert got.dtype == torch.bool and got.shape == (1, N)
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert got[0, :100].all() and not got.all()  # no false negatives; answers vary


@pytest.mark.parametrize("sig_bits,m", GEOMETRIES)
def test_onehot_plain_equals_word_level_plain(sig_bits, m):
    """B8 against the port's B2 / B3 plain versions and the byte-sliced
    query, over 3 lanes of line ids (B3 takes line bitmaps)."""
    _, spec = _specs(sig_bits, m)
    lines, lanes = 5000, 3
    rng = np.random.default_rng(sig_bits * m)
    ids = torch.from_numpy(rng.integers(0, lines, size=(lanes, N)).astype(np.int32))
    valid = torch.from_numpy(rng.random((lanes, N)) < 0.7)
    valid[1] = False  # an all-false lane
    sig0 = torch.zeros((lanes, spec.num_words), dtype=torch.int32)
    onehot = K8.bloom_insert_onehot(spec, sig0, ids, valid)
    word = K.bloom_insert_plain(spec, ids=ids, valid=valid)[:, 0]
    assert torch.equal(onehot, word)
    assert not onehot[1].any()

    probes = torch.from_numpy(rng.integers(0, lines, size=(lanes, 400)).astype(np.int32))
    member = K8.bloom_query_onehot(spec, S.unpack_words(onehot, spec.sig_bits), probes)
    bitmap = torch.zeros((lanes, lines), dtype=torch.bool)
    bitmap.scatter_(1, probes.to(torch.int64), True)
    b3 = K.bloom_query_plain(spec, onehot, S.pack_words(bitmap), lines)
    assert torch.equal(member, S.unpack_words(b3, lines).gather(1, probes.to(torch.int64)))
    for lane in range(lanes):
        assert torch.equal(member[lane], S.query(spec, onehot[lane], probes[lane]))


def test_lanes_are_independent():
    spec = S.default_spec()
    addrs = torch.from_numpy(_addrs(4 * N, 3).view(np.int32).reshape(4, N))
    mask = torch.from_numpy(np.random.default_rng(4).random((4, N)) < 0.5)
    sig0 = torch.zeros((4, spec.num_words), dtype=torch.int32)
    both = K8.bloom_insert_onehot(spec, sig0, addrs, mask)
    bits = S.unpack_words(both, spec.sig_bits)
    member = K8.bloom_query_onehot(spec, bits, addrs)
    for lane in range(4):
        one = K8.bloom_insert_onehot(spec, sig0[lane:lane + 1], addrs[lane:lane + 1],
                                     mask[lane:lane + 1])
        assert torch.equal(both[lane:lane + 1], one)
        assert torch.equal(member[lane:lane + 1], K8.bloom_query_onehot(
            spec, bits[lane:lane + 1], addrs[lane:lane + 1]))
    assert member[mask].all()


# ---------------------------------------------------------------------------
# Dispatch: plain on the CPU, the kernel (or a raise) on CUDA, never mixed
# ---------------------------------------------------------------------------


class _FakeLib:
    """Stands in for the CUDA library: records launches, returns ``rc``."""

    def __init__(self, rc):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append(name)
            return self.rc
        return launch


def _calls():
    spec = S.default_spec()
    addrs = torch.arange(8, dtype=torch.int32)[None]
    sig = torch.zeros((1, spec.num_words), dtype=torch.int32)
    bits = torch.zeros((1, spec.sig_bits), dtype=torch.bool)
    return {
        "bloom_insert_onehot": lambda: K8.bloom_insert_onehot(spec, sig, addrs),
        "bloom_query_onehot": lambda: K8.bloom_query_onehot(spec, bits, addrs),
    }


@pytest.mark.parametrize("rc", [0, 700])
def test_cuda_path_launches_kernel_or_raises_never_plain(monkeypatch, rc):
    fake = _FakeLib(rc)
    monkeypatch.setattr(K8, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(K8, "_lib", lambda: fake)
    monkeypatch.setattr(K8, "_stream", lambda t: 0)
    for name in K8.KERNELS:
        monkeypatch.setattr(K8, f"{name}_plain", None)  # any use would fail
    K8.reset_launch_counts()
    for call in _calls().values():
        if rc:
            with pytest.raises(RuntimeError, match="CUDA error 700"):
                call()
        else:
            call()
    assert fake.calls == ["bloom_insert_onehot_launch", "bloom_query_onehot_launch"]
    assert K8.launch_counts() == {name: 0 if rc else 1 for name in K8.KERNELS}
    K8.reset_launch_counts()


def test_cpu_path_counts_no_launch_and_checks_arguments():
    K8.reset_launch_counts()
    for call in _calls().values():
        call()
    assert K8.launch_counts() == {name: 0 for name in K8.KERNELS}
    spec = S.default_spec()
    addrs = torch.arange(8, dtype=torch.int32)[None]
    sig = torch.zeros((1, spec.num_words), dtype=torch.int32)
    bits = torch.zeros((1, spec.sig_bits), dtype=torch.bool)
    with pytest.raises(ValueError):  # mixed devices
        K8.bloom_insert_onehot(spec, sig, addrs.to("meta"))
    with pytest.raises(ValueError):
        K8.bloom_query_onehot(spec, bits.to("meta"), addrs)
    with pytest.raises(TypeError):
        K8.bloom_insert_onehot(spec, sig, addrs.to(torch.int64))
    with pytest.raises(ValueError):
        K8.bloom_insert_onehot(spec, sig[:, :3], addrs)
    with pytest.raises(ValueError):
        K8.bloom_insert_onehot(spec, sig, addrs, torch.ones((1, 7), dtype=torch.bool))
    with pytest.raises(ValueError):
        K8.bloom_query_onehot(spec, bits[:, :100], addrs)
    with pytest.raises(TypeError):
        K8.bloom_query_onehot(spec.sig_bits, bits, addrs)
    with pytest.raises(ValueError):
        K8.bloom_query_onehot(S.SignatureSpec(sig_bits=1 << 18), bits, addrs)
