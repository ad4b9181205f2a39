"""The CUDA kernels against their plain PyTorch versions on the card, at
edge shapes the main paths can produce (ragged line counts, one slot,
empty lanes, pad bits carrying garbage, sign-bit addresses; for the
LazySync kernels 1 to 16 groups, ragged rows and widths, both dtypes,
all/none/some rows valid; for the seed one-hot kernels every reference
geometry, lanes, ragged N and an all-false mask; for flash attention Sq
from 1 to 4,096 across the 64-row tiles, MHA / GQA / MQA, head dims 64 and
128, both dtypes, windows, and non-causal calls with ragged key tails, on
whichever route each call takes, then the same shapes held to the sm90
route by its route count, odd KV tile counts for its 2-stage ring, the
general route forced on bfloat16 at the sm90 head dims, the general
kernel at head dims across every band of both dtypes (16 to 208 in
float32, to 320 in bfloat16) with Sq over and under Sk and no keys, and
both kernels' registers and shared memory as the loaded binary reports
them; for bloom_intersect's pair-and-any form 1 to 48 lanes, 1 or 16
registers, 1 to 32 segments and all-zero banks and images),
and small end-to-end runs (the Fig. 7 study, the capture study, the seed
engine, nine LazySync steps, a smoke prefill and the smoke serve loop)
held against the CPU path.  The Bloom kernels give integers and the merge
sums in the plain version's order, so their tolerance is exact equality.
Flash attention is held element by element to |kernel - plain| <= rtol
|plain| + row_tol rms(plain row), the RMS taken over each output row's
head dim, so that a row deep in a long causal sequence (whose values
shrink as 1/sqrt(position)) is held to its own scale: float32 rtol 1e-5,
row_tol 1e-3 (the CUDA-core FMA loops differ from the plain version only
in the order of sums); bfloat16 rtol 2^-7 (the two outputs' bf16
roundings one ulp apart) and row_tol 2^-6 (the tensor-core path rounds
the probabilities to bfloat16 for the PV product, ~2^-9 of a row's scale
per element).

These tests need a CUDA device and nvcc; without them they skip.  On the
GPU machine run them with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py
"""

from __future__ import annotations

import dataclasses
import importlib

import pytest
import torch

from repro_torch.core.signatures import (
    SignatureSpec,
    default_spec,
    pack_words,
    popcount_per_word,
    unpack_words,
)
from repro_torch.kernels.bloom import bloom as K
from repro_torch.kernels.bloom import onehot as K8

SPECS = [default_spec(), SignatureSpec(sig_bits=1024, num_segments=2),
         SignatureSpec(sig_bits=8192, num_segments=4)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Bloom kernels have no CPU "
                    "interpreter; their plain versions are tested on the CPU)")
    return torch.device("cuda", 0)


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _words(shape, density, dev, seed):
    bits = torch.rand((*shape, 32), generator=_gen(dev, seed), device=dev) < density
    return pack_words(bits.reshape(*shape[:-1], -1))


# The packed-table kernels (h3_hash, bloom_detect_conflicts) beyond SPECS:
# several words an entry (32 segments), 64-bit entries whose top field holds
# the sign bit (8 x 8 bits), fewer byte slices, and signatures past the
# transposed route's staging cap (the direct route).
PACKED_SPECS = SPECS + [SignatureSpec(sig_bits=2048, num_segments=32),
                        SignatureSpec(sig_bits=2048, num_segments=8),
                        SignatureSpec(sig_bits=4096, num_segments=8, addr_bits=9),
                        SignatureSpec(sig_bits=2**17, num_segments=4)]


def _spec_id(s):
    return f"{s.sig_bits}m{s.num_segments}a{s.addr_bits}"


@pytest.mark.parametrize("spec", PACKED_SPECS, ids=_spec_id)
@pytest.mark.parametrize("n", [1, 33, 4097, 262_145])
def test_h3_hash(dev, spec, n):
    """The paper build (the default spec) and the any-spec build, against
    the byte-sliced tables; sign-bit addresses included."""
    a = torch.randint(-2**31, 2**31 - 1, (n,), generator=_gen(dev, n), device=dev,
                      dtype=torch.int32)
    a[:2] = torch.tensor([-2**31, -1], dtype=torch.int32)[:n]
    assert torch.equal(K.h3_hash(spec, a), K.h3_hash_plain(spec, a))


def test_hash_and_detect_attributes(dev):
    """Every build of h3_hash (paper, any) and of bloom_detect_conflicts
    (transposed paper and any, direct) uses no local memory."""
    for builds, n in ((K.hash_attributes(), 2), (K.detect_attributes(), 3)):
        assert len(builds) == n
        for build_of, a in builds.items():
            assert a["local_bytes"] == 0, build_of
            assert 0 < a["registers"] <= 255, build_of


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s.sig_bits}m{s.num_segments}")
@pytest.mark.parametrize("lanes,slots", [(1, 1), (3, 7), (5, 256), (2, 1000)])
@pytest.mark.parametrize("regs", [1, 16])
def test_insert_ids(dev, spec, lanes, slots, regs):
    g = _gen(dev, lanes * slots + regs)
    ids = torch.randint(-2**31, 2**31 - 1, (lanes, slots), generator=g,
                        device=dev, dtype=torch.int32)
    valid = torch.rand((lanes, slots), generator=g, device=dev) < 0.6
    ids = torch.where(valid | (torch.rand(ids.shape, generator=g, device=dev) < 0.5),
                      ids, -1)
    kw = dict(ids=ids, valid=valid, num_regs=regs)
    assert torch.equal(K.bloom_insert(spec, **kw), K.bloom_insert_plain(spec, **kw))


@pytest.mark.parametrize("num_lines", [1, 31, 33, 6409, 262_144])
@pytest.mark.parametrize("density", [0.0, 0.003, 0.3])
@pytest.mark.parametrize("regs", [1, 16])
def test_insert_bitmap(dev, num_lines, density, regs):
    spec = default_spec()
    nw = (num_lines + 31) // 32
    words = _words((3, nw), density, dev, num_lines)  # pad bits may be set
    kw = dict(bitmap=words, num_lines=num_lines, num_regs=regs)
    assert torch.equal(K.bloom_insert(spec, **kw), K.bloom_insert_plain(spec, **kw))


def _poison(shape, dev) -> int:
    """Leave the next allocation of ``shape`` int32 words on ``dev`` holding
    -1 in every word: the cache is emptied, a block of that shape filled
    with -1 and freed, so the allocator hands it out again.  Returns its
    address, which the caller checks it got."""
    torch.cuda.empty_cache()
    t = torch.full(shape, -1, dtype=torch.int32, device=dev)
    ptr = t.data_ptr()
    del t
    return ptr


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s.sig_bits}m{s.num_segments}")
@pytest.mark.parametrize("lanes,slots,slots_b", [(1, 1, 1), (3, 256, 256), (5, 7, 300),
                                                 (216, 256, 256), (2, 5000, 0)])
@pytest.mark.parametrize("regs", [1, 16])
def test_insert_ids_pair(dev, spec, lanes, slots, slots_b, regs):
    """Both lists from one launch into a poisoned output: each equals its
    plain version and its single call; a list with no valid slot (lane 0
    of the second) gives zeros; 5,000 slots take a cluster of 5 blocks."""
    g = _gen(dev, lanes * slots + slots_b + regs)
    ids = torch.randint(-2**31, 2**31 - 1, (lanes, slots), generator=g, device=dev,
                        dtype=torch.int32)
    ids_b = torch.randint(-2**31, 2**31 - 1, (lanes, slots_b), generator=g, device=dev,
                          dtype=torch.int32)
    valid = torch.rand(ids.shape, generator=g, device=dev) < 0.6
    valid_b = torch.rand(ids_b.shape, generator=g, device=dev) < 0.6
    valid_b[0] = False
    kw = dict(ids=ids, valid=valid, ids_b=ids_b, valid_b=valid_b, num_regs=regs)
    want = K.bloom_insert_plain(spec, **kw)
    ptr = _poison((2, lanes, regs, spec.num_words), dev)
    got = K.bloom_insert(spec, **kw)
    assert got[0].data_ptr() == ptr
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not got[1][0].any()
    assert torch.equal(got[0], K.bloom_insert(spec, ids=ids, valid=valid, num_regs=regs))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s.sig_bits}m{s.num_segments}")
@pytest.mark.parametrize("num_lines", [1, 33, 6409, 32_768, 65_536, 70_000, 262_144,
                                       262_145])
@pytest.mark.parametrize("density", [0.0, 0.003, 0.3], ids=["empty", "sparse", "dense"])
@pytest.mark.parametrize("regs", [1, 16])
def test_insert_bitmap_pair(dev, spec, num_lines, density, regs):
    """Both bitmaps from one launch into a poisoned output, at every width
    the launcher gives its own cluster size (one block a 1,024 words, at
    most 8): one block up to 32,768 lines, 2 blocks at 65,536, 3 at 70,000,
    8 at 262,144 and past it.  Ragged line counts (pad bits set in the last
    word), warps with no word and empty bitmaps all come out exact, zeros
    where no line is set."""
    nw = (num_lines + 31) // 32
    words = _words((3, nw), density, dev, num_lines)  # pad bits may be set
    words_b = _words((3, nw), 0.01, dev, num_lines + 1)
    words_b[1] = 0
    kw = dict(bitmap=words, bitmap_b=words_b, num_lines=num_lines, num_regs=regs)
    want = K.bloom_insert_plain(spec, **kw)
    assert not want[1][1].any()
    ptr = _poison((2, 3, regs, spec.num_words), dev)
    got = K.bloom_insert(spec, **kw)
    assert got[0].data_ptr() == ptr
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    single = K.bloom_insert(spec, bitmap=words, num_lines=num_lines, num_regs=regs)
    assert torch.equal(single, want[0])
    if density == 0.0:
        assert not single.any()


def test_insert_pair_counts_one_launch(dev):
    spec = default_spec()
    ids = torch.arange(8, dtype=torch.int32, device=dev)[None]
    valid = torch.ones((1, 8), dtype=torch.bool, device=dev)
    words = _words((1, 2), 0.5, dev, 6)
    K.reset_launch_counts()
    K.bloom_insert(spec, ids=ids, valid=valid, ids_b=ids, valid_b=valid)
    assert K.launch_counts()["bloom_insert"] == 1
    K.bloom_insert(spec, bitmap=words, bitmap_b=words, num_lines=64, num_regs=16)
    assert K.launch_counts()["bloom_insert"] == 2
    with pytest.raises(ValueError):
        K.bloom_insert(spec, bitmap=words, bitmap_b=words.cpu(), num_lines=64)
    assert K.launch_counts()["bloom_insert"] == 2
    many_ids = ids.expand(65_536, 8).contiguous()  # past gridDim.y's 65,535
    many_valid = valid.expand(65_536, 8).contiguous()
    got = K.bloom_insert(spec, ids=many_ids, valid=many_valid)
    assert K.launch_counts()["bloom_insert"] == 3
    assert torch.equal(got, K.bloom_insert_plain(spec, ids=many_ids, valid=many_valid))
    K.reset_launch_counts()


def _passes(spec) -> int:
    """Launches a parity-form kernel takes for ``spec``: one a 512 masks."""
    return len(K._passes(spec)[0])


@pytest.mark.parametrize("sig_bits,num_segments", [(2048, 64), (2**17, 1)])
def test_insert_spec_beyond_the_mask_cap_is_refused(dev, sig_bits, num_segments):
    """Specs past the old mask cap are inserted on the card, equal to the
    plain version, one launch a pass (one pass each)."""
    spec = SignatureSpec(sig_bits=sig_bits, num_segments=num_segments)
    g = _gen(dev, sig_bits)
    ids = torch.randint(-2**31, 2**31 - 1, (2, 300), generator=g, device=dev,
                        dtype=torch.int32)
    valid = torch.rand((2, 300), generator=g, device=dev) < 0.8
    K.reset_launch_counts()
    K8.reset_launch_counts()
    got = K.bloom_insert(spec, ids=ids, valid=valid)
    assert torch.equal(got, K.bloom_insert_plain(spec, ids=ids, valid=valid))
    got8 = K8.bloom_insert_onehot(spec, None, ids, valid)
    assert torch.equal(got8, K8.bloom_insert_onehot_plain(spec, None, ids, valid))
    assert _passes(spec) == 1
    assert K.launch_counts()["bloom_insert"] == 1
    assert K8.launch_counts()["bloom_insert_onehot"] == 1
    K.reset_launch_counts()
    K8.reset_launch_counts()


@pytest.mark.parametrize("module", ["bloom", "onehot"])
def test_insert_kernels_use_no_local_memory(dev, module):
    """Both builds of every insert kernel keep the column masks in the
    constant bank and the hash's callback inlined: no local memory."""
    attrs = K.insert_attributes() if module == "bloom" else {"ids": K8.insert_attributes()}
    for form, builds in attrs.items():
        for build_of, a in builds.items():
            assert a["local_bytes"] == 0, (form, build_of, a)
            assert 0 < a["registers"] <= 255, (form, build_of, a)


def _dense_words(shape, density, dev, seed):
    """Packed words at ``density``; 1.0 sets every bit."""
    if density >= 1.0:
        return torch.full(shape, -1, dtype=torch.int32, device=dev)
    return _words(shape, density, dev, seed)


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s.sig_bits}m{s.num_segments}")
@pytest.mark.parametrize("num_lines", [1, 31, 33, 6409, 262_144])
@pytest.mark.parametrize("density", [0.0, 0.003, 0.5, 1.0],
                         ids=["zero", "sparse", "half", "full"])
@pytest.mark.parametrize("form", ["single", "pair"])
def test_query(dev, spec, num_lines, density, form):
    """B3 against its plain version: one bitmap or two from one launch, at
    every density, ragged line counts (pad bits of full words carry ones),
    and a signature dense enough that members vary."""
    nw = (num_lines + 31) // 32
    words = _dense_words((3, nw), density, dev, num_lines)
    sig = _words((3, spec.num_words), 0.6, dev, 7)
    if form == "single":
        got = K.bloom_query(spec, sig, words, num_lines)
        assert torch.equal(got, K.bloom_query_plain(spec, sig, words, num_lines))
        outs = (got,)
    else:
        words_b = _dense_words((3, nw), 1.0 - density, dev, num_lines + 1)
        got = K.bloom_query(spec, sig, words, num_lines, words_b=words_b)
        want = K.bloom_query_plain(spec, sig, words, num_lines, words_b=words_b)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[0], K.bloom_query(spec, sig, words, num_lines))
        assert torch.equal(got[1], K.bloom_query(spec, sig, words_b, num_lines))
        outs = got
    for out in outs:
        assert not unpack_words(out, nw * 32)[:, num_lines:].any()


def test_query_lanes_are_independent(dev):
    spec = default_spec()
    lanes, num_lines = 5, 6409
    nw = (num_lines + 31) // 32
    words = _words((lanes, nw), 0.3, dev, 1)
    words_b = _words((lanes, nw), 0.05, dev, 2)
    sig = _words((lanes, spec.num_words), 0.5, dev, 3)
    both = K.bloom_query(spec, sig, words, num_lines, words_b=words_b)
    for lane in range(lanes):
        one = K.bloom_query(spec, sig[lane:lane + 1], words[lane:lane + 1], num_lines,
                            words_b=words_b[lane:lane + 1])
        assert torch.equal(both[0][lane:lane + 1], one[0])
        assert torch.equal(both[1][lane:lane + 1], one[1])


def test_query_pair_counts_one_launch(dev):
    spec = default_spec()
    words = _words((2, 10), 0.5, dev, 4)
    sig = _words((2, spec.num_words), 0.5, dev, 5)
    K.reset_launch_counts()
    K.bloom_query(spec, sig, words, 320, words_b=words)
    assert K.launch_counts()["bloom_query"] == 1
    with pytest.raises(ValueError):
        K.bloom_query(spec, sig, words, 320, words_b=words[:1].contiguous())
    with pytest.raises(ValueError):
        K.bloom_query(spec, sig, words, 320, words_b=words.cpu())  # mixed devices
    K.reset_launch_counts()


@pytest.mark.parametrize("sig_bits,num_segments", [(2048, 64), (2**17, 1)])
def test_query_spec_beyond_the_mask_cap_is_refused(dev, sig_bits, num_segments):
    """Specs past the old mask cap are queried on the card, equal to the
    plain version, one launch each (one pass)."""
    spec = SignatureSpec(sig_bits=sig_bits, num_segments=num_segments)
    sig = _words((2, spec.num_words), 1 - 0.5 / num_segments, dev, sig_bits)
    words = _words((2, 40), 0.5, dev, 3)
    bits = unpack_words(sig, spec.sig_bits).contiguous()
    addrs = torch.randint(-2**31, 2**31 - 1, (2, 999), generator=_gen(dev, 4),
                          device=dev, dtype=torch.int32)
    K.reset_launch_counts()
    K8.reset_launch_counts()
    got = K.bloom_query(spec, sig, words, 1270)
    assert torch.equal(got, K.bloom_query_plain(spec, sig, words, 1270))
    got8 = K8.bloom_query_onehot(spec, bits, addrs)
    want8 = K8.bloom_query_onehot_plain(spec, bits, addrs)
    assert torch.equal(got8, want8) and 0 < int(want8.sum()) < want8.numel()
    assert K.launch_counts()["bloom_query"] == 1
    assert K8.launch_counts()["bloom_query_onehot"] == 1
    K.reset_launch_counts()
    K8.reset_launch_counts()


@pytest.mark.parametrize("module", ["bloom", "onehot"])
def test_query_kernels_use_no_local_memory(dev, module):
    """The column masks are a __grid_constant__ parameter: dynamic indexing
    reads them in place, with no copy to local memory."""
    for build_of, attrs in (K if module == "bloom" else K8).query_attributes().items():
        assert attrs["local_bytes"] == 0, (build_of, attrs)
        assert 0 < attrs["registers"] <= 255, (build_of, attrs)


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s.sig_bits}m{s.num_segments}")
@pytest.mark.parametrize("lanes,regs", [(1, 1), (7, 1), (3, 16)])
def test_intersect(dev, spec, lanes, regs):
    g = _gen(dev, lanes * regs)
    dens = torch.rand((lanes * regs, 1, 1), generator=g, device=dev) * 0.02
    bits = torch.rand((lanes * regs, spec.num_words, 32), generator=g, device=dev) < dens
    a = pack_words(bits.reshape(lanes * regs, -1))
    b = _words((lanes, spec.num_words), 0.05, dev, 3)
    got = K.bloom_intersect(a, b, spec.num_segments)
    assert torch.equal(got, K.bloom_intersect_plain(a, b, spec.num_segments))


@pytest.mark.parametrize("lanes", [1, 3, 48])
@pytest.mark.parametrize("regs", [1, 16])
@pytest.mark.parametrize("m", [1, 4, 32])
@pytest.mark.parametrize("nw", [64, 256])
@pytest.mark.parametrize("kind", ["random", "zeros"])
def test_intersect_pair(dev, lanes, regs, m, nw, kind):
    """The pair-and-any form: one launch for both banks, equal to its plain
    version and to two per-row calls and their .any over registers;
    all-zero banks and images give False."""
    dens = 0.0 if kind == "zeros" else 0.15
    a = _words((lanes * regs, nw), dens, dev, lanes + regs)
    a_b = _words((lanes * regs, nw), dens / 3, dev, lanes + regs + 1)
    b = _words((lanes, nw), 0.0 if kind == "zeros" else 0.3, dev, m)
    K.reset_launch_counts()
    got = K.bloom_intersect(a, b, m, a_b=a_b)
    assert K.launch_counts()["bloom_intersect"] == 1
    assert got.shape == (2, lanes) and got.dtype == torch.bool
    assert torch.equal(got, K.bloom_intersect_plain(a, b, m, a_b))
    two = torch.stack([K.bloom_intersect(x, b, m).reshape(lanes, regs).any(1)
                       for x in (a, a_b)])
    assert torch.equal(got, two)
    if kind == "zeros":
        assert not got.any()
    K.reset_launch_counts()


def test_launch_counts_and_device_checks(dev):
    spec = default_spec()
    sigs = torch.zeros((4, spec.num_words), dtype=torch.int32, device=dev)
    K.reset_launch_counts()
    K.h3_hash(spec, torch.arange(10, dtype=torch.int32, device=dev))
    K.h3_hash(spec, torch.arange(0, dtype=torch.int32, device=dev))  # no launch
    assert K.launch_counts()["h3_hash"] == 1
    with pytest.raises(ValueError):
        K.bloom_detect_conflicts(spec, sigs, torch.arange(10, dtype=torch.int32))  # mixed
    K.reset_launch_counts()


def test_small_study_on_card_equals_cpu(dev):
    """The whole path on the card equals the CPU path on every field."""
    from repro_torch.api import Study

    wl = ["pagerank-arxiv", "htap128"]
    gpu = Study(wl, device=dev).run()
    cpu = Study(wl, device="cpu").run()
    for a, b in zip(gpu.points, cpu.points):
        for m in a.results:
            assert dataclasses.asdict(a.results[m]) == dataclasses.asdict(b.results[m])


# ---------------------------------------------------------------------------
# Seed one-hot kernels (B8): bloom_insert_onehot and bloom_query_onehot
# ---------------------------------------------------------------------------

ONEHOT_SPECS = [SignatureSpec(sig_bits=s, num_segments=m)
                for s in (512, 2048, 4096) for m in (2, 4, 8)]


def _onehot_mask(kind, shape, dev, seed):
    if kind == "unmasked":
        return None
    if kind == "all_false":
        return torch.zeros(shape, dtype=torch.bool, device=dev)
    return torch.rand(shape, generator=_gen(dev, seed), device=dev) < 0.5


@pytest.mark.parametrize("spec", ONEHOT_SPECS, ids=lambda s: f"{s.sig_bits}m{s.num_segments}")
@pytest.mark.parametrize("lanes,n", [(1, 1), (1, 1024), (3, 300), (2, 5000)])
@pytest.mark.parametrize("mask_kind", ["random", "all_false", "unmasked"])
def test_insert_onehot(dev, spec, lanes, n, mask_kind):
    """Sign-bit addresses, ragged N over the 1,024-address blocks, an
    incoming signature that is not empty."""
    g = _gen(dev, lanes * n + spec.sig_bits)
    addrs = torch.randint(-2**31, 2**31 - 1, (lanes, n), generator=g, device=dev,
                          dtype=torch.int32)
    sig = _words((lanes, spec.num_words), 0.02, dev, n)
    mask = _onehot_mask(mask_kind, (lanes, n), dev, n + 1)
    got = K8.bloom_insert_onehot(spec, sig, addrs, mask)
    assert torch.equal(got, K8.bloom_insert_onehot_plain(spec, sig, addrs, mask))
    if mask_kind == "all_false":
        assert torch.equal(got, sig)


@pytest.mark.parametrize("spec", [default_spec(), SignatureSpec(sig_bits=512, num_segments=2),
                                  SignatureSpec(sig_bits=4096, num_segments=8)],
                         ids=lambda s: f"{s.sig_bits}m{s.num_segments}")
@pytest.mark.parametrize("lanes,n,n_b", [(1, 256, 256), (3, 300, 1), (2, 5000, 1024),
                                         (1, 168_335, 256)])
@pytest.mark.parametrize("with_sig", [False, True], ids=["no_sig", "sig"])
def test_insert_onehot_pair(dev, spec, lanes, n, n_b, with_sig):
    """Both lists from one launch, with and without an incoming signature,
    into a poisoned output; N from one block to the whole-bitmap call's
    168,335 (a cluster of 8); a list with every slot masked off gives the
    signature alone."""
    g = _gen(dev, lanes * n + n_b + spec.sig_bits)
    addrs = torch.randint(-2**31, 2**31 - 1, (lanes, n), generator=g, device=dev,
                          dtype=torch.int32)
    addrs_b = torch.randint(-2**31, 2**31 - 1, (lanes, n_b), generator=g, device=dev,
                            dtype=torch.int32)
    mask = torch.rand(addrs.shape, generator=g, device=dev) < 0.5
    mask_b = torch.rand(addrs_b.shape, generator=g, device=dev) < 0.5
    mask_b[0] = False
    sig = _words((lanes, spec.num_words), 0.02, dev, n) if with_sig else None
    want = K8.bloom_insert_onehot_plain(spec, sig, addrs, mask, addrs_b=addrs_b,
                                        mask_b=mask_b)
    ptr = _poison((2, lanes, spec.num_words), dev)
    got = K8.bloom_insert_onehot(spec, sig, addrs, mask, addrs_b=addrs_b, mask_b=mask_b)
    assert got[0].data_ptr() == ptr
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    zero = torch.zeros_like(got[1][0])
    assert torch.equal(got[1][0], zero if sig is None else sig[0])
    assert torch.equal(got[0], K8.bloom_insert_onehot(spec, sig, addrs, mask))


def test_insert_onehot_whole_bitmap_equals_word_insert(dev):
    """The seed path's whole-bitmap image (N = num_lines, a cluster of 8)
    equals B2's bitmap image of the same lines."""
    from repro_torch.sim.prep import prepare, sig_bits_from_bitmap, sig_bits_from_bitmap_bool
    from repro_torch.sim.trace import make_trace

    tt = prepare(make_trace("pagerank", "arxiv", num_kernels=3, device=dev), device=dev)
    bits = torch.rand((2, tt.num_lines), generator=_gen(dev, 3), device=dev) < 0.01
    got = sig_bits_from_bitmap_bool(tt, bits)
    assert torch.equal(pack_words(got), sig_bits_from_bitmap(tt, pack_words(bits)))


def _image(kind, lanes, sig_bits, dev, g):
    if kind == "zeros":
        return torch.zeros((lanes, sig_bits), dtype=torch.bool, device=dev)
    if kind == "ones":
        return torch.ones((lanes, sig_bits), dtype=torch.bool, device=dev)
    return torch.rand((lanes, sig_bits), generator=g, device=dev) < float(kind)


@pytest.mark.parametrize("spec", ONEHOT_SPECS, ids=lambda s: f"{s.sig_bits}m{s.num_segments}")
@pytest.mark.parametrize("lanes,n", [(1, 1), (1, 3), (1, 255), (1, 168_335), (3, 257),
                                     (2, 70_000)])
@pytest.mark.parametrize("image", ["0.3", "0.9", "zeros", "ones"])
def test_query_onehot(dev, spec, lanes, n, image):
    """B8b against its plain version: one address, fewer addresses than a
    block's threads, more than one block a lane, the seed path's 168,335
    lines, L > 1 with lanes one after another in ``addrs``, random images
    whose answers must vary, and all-zero / all-one images (every address
    fails at its first segment, or hashes all M)."""
    g = _gen(dev, lanes * n + spec.num_segments)
    addrs = torch.randint(-2**31, 2**31 - 1, (lanes, n), generator=g, device=dev,
                          dtype=torch.int32)
    bits = _image(image, lanes, spec.sig_bits, dev, g)
    got = K8.bloom_query_onehot(spec, bits, addrs)
    want = K8.bloom_query_onehot_plain(spec, bits, addrs)
    assert torch.equal(got, want)
    if image == "zeros":
        assert not got.any()
    elif image == "ones":
        assert got.all()
    elif n > 1000:
        assert 0 < int(want.sum()) < want.numel()  # the answers vary


def test_query_onehot_offset_rows_and_lanes(dev):
    """Addresses and images that start off a 16-byte boundary take the
    scalar paths; lanes stay independent."""
    spec = default_spec()
    g = _gen(dev, 11)
    big = torch.randint(-2**31, 2**31 - 1, (1, 5001), generator=g, device=dev,
                        dtype=torch.int32)
    addrs = big[:, 1:]                         # contiguous, 4 bytes in
    img = torch.rand((1, spec.sig_bits + 1), generator=g, device=dev) < 0.8
    bits = img[:, 1:]                          # contiguous, 1 byte in
    assert addrs.is_contiguous() and bits.is_contiguous()
    assert torch.equal(K8.bloom_query_onehot(spec, bits, addrs),
                       K8.bloom_query_onehot_plain(spec, bits, addrs))
    lanes = torch.randint(-2**31, 2**31 - 1, (4, 999), generator=g, device=dev,
                          dtype=torch.int32)
    images = torch.rand((4, spec.sig_bits), generator=g, device=dev) < 0.85
    both = K8.bloom_query_onehot(spec, images, lanes)
    for lane in range(4):
        assert torch.equal(both[lane:lane + 1], K8.bloom_query_onehot(
            spec, images[lane:lane + 1], lanes[lane:lane + 1]))


def test_onehot_launch_counts_and_device_checks(dev):
    spec = default_spec()
    addrs = torch.arange(10, dtype=torch.int32, device=dev)[None]
    sig = torch.zeros((1, spec.num_words), dtype=torch.int32, device=dev)
    K8.reset_launch_counts()
    img = K8.bloom_insert_onehot(spec, sig, addrs)
    K8.bloom_insert_onehot(spec, sig, addrs[:, :0])  # no launch
    K8.bloom_query_onehot(spec, unpack_words(img, spec.sig_bits), addrs)
    assert K8.launch_counts() == {"bloom_insert_onehot": 1, "bloom_query_onehot": 1}
    with pytest.raises(ValueError):
        K8.bloom_insert_onehot(spec, sig.cpu(), addrs)  # mixed devices
    with pytest.raises(ValueError):
        K8.bloom_query_onehot(spec, unpack_words(img, spec.sig_bits), addrs.cpu())
    K8.reset_launch_counts()


def test_seed_engine_on_card_equals_cpu_and_packed(dev):
    """run_all_bool on the card equals its CPU run and the packed engine on
    every field, and its Bloom primitives went through B8."""
    from repro_torch.core._boolref import run_all_bool
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.sim.engine import run_all
    from repro_torch.sim.prep import prepare
    from repro_torch.sim.trace import make_trace

    def prep(device):
        return prepare(make_trace("pagerank", "arxiv", num_kernels=3, device=device),
                       device=device)

    reset_launch_counts()
    gpu = run_all_bool(prep(dev))
    counts = launch_counts()
    assert counts["bloom_insert_onehot"] > 0 and counts["bloom_query_onehot"] > 0
    cpu = run_all_bool(prep("cpu"))
    packed = run_all(prep(dev), device=dev)
    for m in gpu:
        assert dataclasses.asdict(gpu[m]) == dataclasses.asdict(cpu[m]), m
        assert dataclasses.asdict(gpu[m]) == dataclasses.asdict(packed[m]), m
    reset_launch_counts()


# ---------------------------------------------------------------------------
# Specs and lane counts past the kernels' old caps (ROADMAP §C3): more than
# 32 segments, more than the 512 column masks of one launch (passes), more
# address bits than a line id has, outputs larger than a block's shared
# memory, and more than 65,535 lanes
# ---------------------------------------------------------------------------

C3_SPECS = [SignatureSpec(4096, 64), SignatureSpec(2048, 64),
            SignatureSpec(4096, 128),            # 640 masks: two passes
            SignatureSpec(2**16, 64),            # 640 masks of 10 bits: two passes
            SignatureSpec(2**18, 2),             # 17-bit segments; a 16-register bank of 512 KB
            SignatureSpec(4096, 64, addr_bits=48)]


def _c3_id(s):
    return f"{s.sig_bits}m{s.num_segments}a{s.addr_bits}"


def _member_density(spec):
    """A signature density at which about half the addresses are members."""
    return 1 - 0.5 / spec.num_segments


@pytest.mark.parametrize("spec", C3_SPECS, ids=_c3_id)
def test_c3_hash_and_detect(dev, spec):
    """B1 and B5 at specs past their old cap, against the plain versions."""
    g = _gen(dev, spec.num_segments)
    a = torch.randint(-2**31, 2**31 - 1, (4097,), generator=g, device=dev,
                      dtype=torch.int32)
    assert torch.equal(K.h3_hash(spec, a), K.h3_hash_plain(spec, a))
    sigs = _words((4, spec.num_words), _member_density(spec), dev, 5)
    want = K.bloom_detect_conflicts_plain(spec, sigs, a)
    assert torch.equal(K.bloom_detect_conflicts(spec, sigs, a), want)
    assert int(want.min()) < int(want.max())


@pytest.mark.parametrize("spec", C3_SPECS, ids=_c3_id)
@pytest.mark.parametrize("regs", [1, 16])
def test_c3_insert(dev, spec, regs):
    """B2's id and bitmap pairs at specs past the old cap, into poisoned
    outputs, one launch a pass."""
    g = _gen(dev, spec.sig_bits + regs)
    ids = torch.randint(-2**31, 2**31 - 1, (3, 256), generator=g, device=dev,
                        dtype=torch.int32)
    valid = torch.rand((3, 256), generator=g, device=dev) < 0.8
    words = _words((3, 205), 0.01, dev, regs)
    words_b = _words((3, 205), 0.002, dev, regs + 1)
    K.reset_launch_counts()
    want = K.bloom_insert_plain(spec, ids=ids, valid=valid, ids_b=ids[:, :100].contiguous(),
                                valid_b=valid[:, 50:150].contiguous(), num_regs=regs)
    _poison((2, 3, regs, spec.num_words), dev)
    got = K.bloom_insert(spec, ids=ids, valid=valid, ids_b=ids[:, :100].contiguous(),
                         valid_b=valid[:, 50:150].contiguous(), num_regs=regs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    want = K.bloom_insert_plain(spec, bitmap=words, bitmap_b=words_b, num_lines=6550,
                                num_regs=regs)
    _poison((2, 3, regs, spec.num_words), dev)
    got = K.bloom_insert(spec, bitmap=words, bitmap_b=words_b, num_lines=6550, num_regs=regs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert K.launch_counts()["bloom_insert"] == 2 * _passes(spec)
    K.reset_launch_counts()


@pytest.mark.parametrize("spec", C3_SPECS, ids=_c3_id)
def test_c3_query_and_intersect(dev, spec):
    """B3 (one bitmap and two) and B4 (per row and pair-and-any) at specs
    past the old cap; B3 one launch a pass, B4 one launch."""
    sig = _words((3, spec.num_words), _member_density(spec), dev, 9)
    words = _words((3, 205), 0.4, dev, 10)
    words_b = _words((3, 205), 0.2, dev, 11)
    K.reset_launch_counts()
    want = K.bloom_query_plain(spec, sig, words, 6550, words_b)
    got = K.bloom_query(spec, sig, words, 6550, words_b=words_b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert 0 < int(popcount_per_word(want[0]).sum()) < int(popcount_per_word(words).sum())
    assert torch.equal(K.bloom_query(spec, sig, words, 6550),
                       K.bloom_query_plain(spec, sig, words, 6550))
    assert K.launch_counts()["bloom_query"] == 2 * _passes(spec)
    m = spec.num_segments
    # a density at which a & b (b at 0.5) meets every segment in about half
    # the rows: each segment empty with probability 1 - 0.5 ** (1 / M)
    empty = 1 - 0.5 ** (1 / m)
    a = _words((3 * 16, spec.num_words), 2 * (1 - empty ** (1 / spec.seg_bits)), dev, 12)
    a_b = _words((3 * 16, spec.num_words), 0.3, dev, 13)
    b = _words((3, spec.num_words), 0.5, dev, 14)
    rows = K.bloom_intersect(a, b, m)
    assert torch.equal(rows, K.bloom_intersect_plain(a, b, m))
    assert 0 < int(rows.sum()) < rows.numel()
    pair = K.bloom_intersect(a, b, m, a_b=a_b)
    assert torch.equal(pair, K.bloom_intersect_plain(a, b, m, a_b))
    assert K.launch_counts()["bloom_intersect"] == 2
    K.reset_launch_counts()


@pytest.mark.parametrize("spec", C3_SPECS, ids=_c3_id)
def test_c3_onehot(dev, spec):
    """B8a (a pair with an incoming signature) and B8b at specs past their
    old caps, one launch a pass each."""
    g = _gen(dev, spec.sig_bits + 1)
    addrs = torch.randint(-2**31, 2**31 - 1, (2, 300), generator=g, device=dev,
                          dtype=torch.int32)
    mask = torch.rand((2, 300), generator=g, device=dev) < 0.5
    sig = _words((2, spec.num_words), 0.01, dev, 15)
    K8.reset_launch_counts()
    want = K8.bloom_insert_onehot_plain(spec, sig, addrs, mask, addrs_b=addrs[:, :7].contiguous())
    got = K8.bloom_insert_onehot(spec, sig, addrs, mask, addrs_b=addrs[:, :7].contiguous())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    bits = unpack_words(_words((2, spec.num_words), _member_density(spec), dev, 16),
                        spec.sig_bits).contiguous()
    want = K8.bloom_query_onehot_plain(spec, bits, addrs)
    assert torch.equal(K8.bloom_query_onehot(spec, bits, addrs), want)
    assert 0 < int(want.sum()) < want.numel()
    assert K8.launch_counts() == {"bloom_insert_onehot": _passes(spec),
                                  "bloom_query_onehot": _passes(spec)}
    K8.reset_launch_counts()


LANES_PAST_GRID = 70_000


@pytest.mark.parametrize("kernel", ["query", "query_pair", "insert_ids", "insert_bitmap",
                                    "insert_onehot", "query_onehot", "intersect_pair"])
def test_lanes_past_the_grid_limit(dev, kernel):
    """70,000 lanes of a small bitmap or list (past gridDim.y's 65,535):
    one launch, equal to the plain version, every lane its own."""
    spec = default_spec()
    lanes = LANES_PAST_GRID
    g = _gen(dev, 70)
    words = _words((lanes, 2), 0.3, dev, 71)
    ids = torch.randint(-2**31, 2**31 - 1, (lanes, 8), generator=g, device=dev,
                        dtype=torch.int32)
    valid = torch.rand((lanes, 8), generator=g, device=dev) < 0.7
    sig = _words((lanes, spec.num_words), 0.8, dev, 72)
    K.reset_launch_counts()
    K8.reset_launch_counts()
    if kernel == "query":
        got, want = K.bloom_query(spec, sig, words, 60), K.bloom_query_plain(spec, sig, words, 60)
    elif kernel == "query_pair":
        got = torch.stack(K.bloom_query(spec, sig, words, 60, words_b=words.flip(0)))
        want = torch.stack(K.bloom_query_plain(spec, sig, words, 60, words.flip(0)))
    elif kernel == "insert_ids":
        got = K.bloom_insert(spec, ids=ids, valid=valid)
        want = K.bloom_insert_plain(spec, ids=ids, valid=valid)
    elif kernel == "insert_bitmap":
        got = torch.stack(K.bloom_insert(spec, bitmap=words, bitmap_b=words.flip(0),
                                         num_lines=60, num_regs=4))
        want = torch.stack(K.bloom_insert_plain(spec, bitmap=words, bitmap_b=words.flip(0),
                                                num_lines=60, num_regs=4))
    elif kernel == "insert_onehot":
        got = K8.bloom_insert_onehot(spec, sig, ids, valid)
        want = K8.bloom_insert_onehot_plain(spec, sig, ids, valid)
    elif kernel == "query_onehot":
        bits = unpack_words(sig, spec.sig_bits).contiguous()
        got = K8.bloom_query_onehot(spec, bits, ids)
        want = K8.bloom_query_onehot_plain(spec, bits, ids)
    else:
        bank = _words((lanes * 2, spec.num_words), 0.002, dev, 73)
        got = K.bloom_intersect(bank, sig, spec.num_segments, a_b=bank.flip(0))
        want = K.bloom_intersect_plain(bank, sig, spec.num_segments, bank.flip(0))
    assert torch.equal(got, want)
    assert bool((want != want[-1:]).any())  # the lanes' answers differ
    assert sum(K.launch_counts().values()) + sum(K8.launch_counts().values()) == 1
    K.reset_launch_counts()
    K8.reset_launch_counts()


def test_paper_geometry_launches_once_a_call(dev):
    """The paper's spec keeps its fixed-geometry builds in one launch a
    call (one pass) on every Bloom kernel."""
    spec = default_spec()
    assert _passes(spec) == 1 and K._passes(spec)[0][0][1] == 0
    ids = torch.arange(64, dtype=torch.int32, device=dev)[None]
    valid = torch.ones_like(ids, dtype=torch.bool)
    words = _words((1, 4), 0.5, dev, 1)
    sig = _words((1, spec.num_words), 0.5, dev, 2)
    K.reset_launch_counts()
    K8.reset_launch_counts()
    K.h3_hash(spec, ids[0])
    K.bloom_insert(spec, ids=ids, valid=valid, ids_b=ids, valid_b=valid)
    K.bloom_insert(spec, bitmap=words, bitmap_b=words, num_lines=128, num_regs=16)
    K.bloom_query(spec, sig, words, 128, words_b=words)
    K.bloom_intersect(sig.expand(16, -1).contiguous(), sig, 4, a_b=sig.expand(16, -1).contiguous())
    K.bloom_detect_conflicts(spec, sig, ids[0])
    K8.bloom_insert_onehot(spec, sig, ids, addrs_b=ids)
    K8.bloom_query_onehot(spec, unpack_words(sig, spec.sig_bits).contiguous(), ids)
    assert K.launch_counts() == {"h3_hash": 1, "bloom_insert": 2, "bloom_query": 1,
                                 "bloom_intersect": 1, "bloom_detect_conflicts": 1}
    assert K8.launch_counts() == {"bloom_insert_onehot": 1, "bloom_query_onehot": 1}
    K.reset_launch_counts()
    K8.reset_launch_counts()


@pytest.mark.parametrize("sig_bits", [4096, 2048])
def test_many_segments_study_on_card_equals_cpu(dev, sig_bits):
    """The M = 64 Study of tests/test_torch_signature_caps.py on the card:
    every field of 2 workloads x 6 mechanisms equal to the CPU run, on
    both engines, through the kernels."""
    from repro_torch.api import Study, workload
    from repro_torch.kernels import launch_counts, reset_launch_counts

    spec = SignatureSpec(sig_bits=sig_bits, num_segments=64)
    wl = [workload("htap128", num_kernels=4, windows_per_kernel=2),
          workload("pagerank", "arxiv", num_kernels=4, windows_per_kernel=2)]
    cpu = Study(wl, spec=spec, device="cpu").run(engine="sequential")
    for engine in ("batch", "sequential"):
        reset_launch_counts()
        gpu = Study(wl, spec=spec, device=dev).run(engine=engine)
        counts = launch_counts()
        for name in ("h3_hash", "bloom_insert", "bloom_query", "bloom_intersect"):
            assert counts[name] > 0, (engine, name)
        for a, b in zip(gpu.points, cpu.points):
            for m in a.results:
                assert dataclasses.asdict(a.results[m]) == dataclasses.asdict(b.results[m])
    reset_launch_counts()


# ---------------------------------------------------------------------------
# LazySync kernels: bloom_detect_conflicts (B5) and lazy_merge (B6)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", PACKED_SPECS, ids=_spec_id)
@pytest.mark.parametrize("groups", [1, 4, 16])
@pytest.mark.parametrize("n", [1, 192, 255, 257, 16_384, 70_000])
def test_detect_conflicts(dev, spec, groups, n):
    """Sign-bit ids included; the signatures are dense enough that counts
    from 0 to G all occur at the larger N; past one address a thread of a
    one-wave grid at 70,000; on the route the spec picks, counted."""
    g = _gen(dev, n * groups)
    ids = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    ids[:2 if n > 1 else 1] = torch.tensor([-2**31, -1][:n], dtype=torch.int32)
    density = 0.7 ** (4 / spec.num_segments)  # a member in every group ~0.24
    sigs = _words((groups, spec.num_words), density, dev, n + groups)
    K.reset_launch_counts()
    got = K.bloom_detect_conflicts(spec, sigs, ids)
    route = K.detect_route(spec)
    assert K.detect_route_counts() == {r: int(r == route) for r in K.DETECT_ROUTES}
    assert route == ("direct" if spec.sig_bits > 2**15 else "transposed")
    K.reset_launch_counts()
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert torch.equal(got, K.bloom_detect_conflicts_plain(spec, sigs, ids))


def test_detect_conflicts_counts_own_ids(dev):
    """Every group's own ids are found in its signature (no false
    negatives), through the signature-level wrapper."""
    from repro_torch.core.signatures import insert
    from repro_torch.kernels.bloom import ops

    spec = default_spec()
    ids = torch.randint(-2**31, 2**31 - 1, (4, 100), generator=_gen(dev, 1),
                        device=dev, dtype=torch.int32)
    sigs = torch.stack([insert(spec, torch.zeros(spec.num_words, dtype=torch.int32,
                                                 device=dev), ids[g]) for g in range(4)])
    counts = ops.bloom_detect_conflicts(spec, sigs, ids.reshape(-1))
    assert int(counts.min()) >= 1


LM = importlib.import_module("repro_torch.kernels.lazy_merge.lazy_merge")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,r,d", [(1, 1, 1), (4, 1024, 2560), (3, 37, 13),
                                   (16, 5, 2559), (2, 300, 64), (4, 129, 130)])
@pytest.mark.parametrize("valid_kind", ["random", "all", "none"])
def test_lazy_merge(dev, dtype, g, r, d, valid_kind):
    """Ragged R and D (no padding), both dtypes, every validity pattern:
    the kernel equals the plain version bit for bit."""
    gen = _gen(dev, g * r * d)
    rows = torch.randn((g, r, d), generator=gen, device=dev).to(dtype)
    base = torch.randn((r, d), generator=gen, device=dev).to(dtype)
    valid = {"random": torch.rand((r,), generator=gen, device=dev) < 0.5,
             "all": torch.ones((r,), dtype=torch.bool, device=dev),
             "none": torch.zeros((r,), dtype=torch.bool, device=dev)}[valid_kind]
    got = LM.lazy_merge(rows, base, valid)
    assert got.dtype == torch.float32 and got.shape == (r, d)
    assert torch.equal(got, LM.lazy_merge_plain(rows, base, valid))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lazy_merge_unaligned_rows(dev, dtype):
    """A view that starts off a 16-byte boundary takes the scalar path."""
    flat = torch.randn((4 * 100 * 64 + 1,), generator=_gen(dev, 5), device=dev).to(dtype)
    rows = flat[1:].view(4, 100, 64)
    base = torch.randn((100, 64), generator=_gen(dev, 6), device=dev).to(dtype)
    valid = torch.ones((100,), dtype=torch.bool, device=dev)
    assert torch.equal(LM.lazy_merge(rows, base, valid),
                       LM.lazy_merge_plain(rows, base, valid))


def test_lazysync_on_card_equals_cpu(dev):
    """Nine sync_steps (two commits) of the smoke-width LazyEmbed on the
    card equal the same steps on the CPU: rows, streak, metrics and params
    bit for bit, and B5 and B6 were launched."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.lazy_sync import LazyEmbed, LazySyncConfig, init_state
    from repro_torch.kernels import launch_counts, reset_launch_counts

    mcfg = get_smoke_config("qwen3_4b")
    cfg = LazySyncConfig(num_groups=4, commit_interval=4, max_reconcile_rows=64)
    emb = LazyEmbed(mcfg, cfg)
    cpu = emb.init(torch.Generator().manual_seed(0))
    gpu = {k: v.to(dev) for k, v in cpu.items()}
    s_cpu, s_gpu = init_state(cfg, mcfg.vocab, "cpu"), init_state(cfg, mcfg.vocab, dev)
    rng = np.random.default_rng(0)
    reset_launch_counts()
    for _ in range(9):
        u = rng.random((4, 32))
        touched = torch.from_numpy(np.minimum(mcfg.vocab * u ** 3, mcfg.vocab - 1)
                                   .astype(np.int32))
        grads = torch.zeros((4, mcfg.vocab, mcfg.d_model))
        grads[:, :64] = torch.from_numpy(rng.normal(size=(4, 64, mcfg.d_model))
                                         .astype(np.float32))
        cpu, s_cpu, m_cpu = emb.sync_step(cpu, s_cpu, touched, grads)
        gpu, s_gpu, m_gpu = emb.sync_step(gpu, s_gpu, touched.to(dev), grads.to(dev))
        for k in m_cpu:
            assert int(m_cpu[k]) == int(m_gpu[k]), k
        assert torch.equal(s_cpu["streak"], s_gpu["streak"].cpu())
        for k in cpu:
            assert torch.equal(cpu[k], gpu[k].cpu()), k
    counts = launch_counts()
    assert counts["bloom_detect_conflicts"] == 9 and counts["lazy_merge"] == 9 + 2
    reset_launch_counts()


def test_capture_study_on_card_equals_cpu(dev):
    from repro_torch.api import Study

    kw = dict(num_kernels=3, windows_per_kernel=2, scale=0.05)
    from repro_torch.api import workload

    wl = [workload("capture/lazy_embed", **kw)]
    gpu = Study(wl, device=dev).run()
    cpu = Study(wl, device="cpu").run()
    for a, b in zip(gpu.points, cpu.points):
        for m in a.results:
            assert dataclasses.asdict(a.results[m]) == dataclasses.asdict(b.results[m])


# ---------------------------------------------------------------------------
# Flash attention (B7)
# ---------------------------------------------------------------------------

FA_TOL = {torch.float32: (1e-5, 1e-3), torch.bfloat16: (2.0 ** -7, 2.0 ** -6)}  # rtol, row_tol


@pytest.fixture
def no_tf32():
    """Full float32 matmuls (no TF32) in the plain versions and models that
    float32 results are held to (PyTorch's default, stated and restored)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


def _qkv(dev, b, sq, sk, hq, hkv, d, dtype, seed):
    g = _gen(dev, seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))]


def _fa_check(q, k, v, route=None, **kw):
    from repro_torch.kernels.flash_attention import flash_attention as FA

    out = (FA.flash_attention(q, k, v, **kw) if route is None
           else FA._flash_attention(q, k, v, route=route, **kw))
    want = FA.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    assert bool(out.to(torch.float32).isfinite().all())
    rtol, row_tol = FA_TOL[q.dtype]
    got, want = out.to(torch.float32), want.to(torch.float32)
    diff = (got - want).abs()
    allowed = rtol * want.abs() + row_tol * want.pow(2).mean(-1, keepdim=True).sqrt()
    bad = diff > allowed
    assert not bool(bad.any()), (
        f"{int(bad.sum())} elements out of tolerance; max |diff| {float(diff.max()):.4g}, "
        f"max |diff| / allowed {float(torch.where(diff == 0, 0.0, diff / allowed).max()):.3g}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (4, 1)], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("sq", [1, 127, 128, 129, 200, 4096])
def test_flash_attention_causal(dev, no_tf32, dtype, d, hq, hkv, sq):
    b = 1 if sq == 4096 else 2
    _fa_check(*_qkv(dev, b, sq, sq, hq, hkv, d, dtype, sq + d), causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [1, 64, 100, 256])
@pytest.mark.parametrize("sq", [129, 1000])
def test_flash_attention_window(dev, no_tf32, dtype, window, sq):
    _fa_check(*_qkv(dev, 2, sq, sq, 8, 2, 64, dtype, window), causal=True, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(1, 1), (128, 256), (129, 200), (64, 4096), (300, 77)])
def test_flash_attention_noncausal_ragged(dev, no_tf32, dtype, sq, sk):
    _fa_check(*_qkv(dev, 2, sq, sk, 4, 2, 128, dtype, sq * sk), causal=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_sq_over_sk_and_odd_dims(dev, no_tf32, dtype):
    """Sq > Sk under a causal window (fully masked rows give 0) and the
    registered archs' other head dims (16, 96, 192)."""
    q, k, v = _qkv(dev, 1, 300, 100, 4, 2, 64, dtype, 1)
    _fa_check(q, k, v, causal=True, window=16)
    from repro_torch.kernels.flash_attention import flash_attention as FA

    assert not bool(FA.flash_attention(q, k, v, causal=True, window=16)[:, 120:].any())
    for d in (16, 96, 192):
        _fa_check(*_qkv(dev, 2, 200, 200, 4, 2, d, dtype, d), causal=True)


def test_flash_attention_launch_counts_and_checks(dev):
    from repro_torch.kernels.flash_attention import flash_attention as FA

    FA.reset_launch_counts()
    q, k, v = _qkv(dev, 1, 64, 64, 2, 1, 64, torch.bfloat16, 0)
    FA.flash_attention(q, k, v)
    assert FA.launch_counts() == {"flash_attention": 1}
    with pytest.raises(ValueError):
        FA.flash_attention(q, k.cpu(), v)
    with pytest.raises(RuntimeError, match="CUDA error"):
        FA.flash_attention(*_qkv(dev, 1, 8, 8, 2, 1, 24, torch.bfloat16, 0))
    assert FA.launch_counts() == {"flash_attention": 1}
    FA.reset_launch_counts()


@pytest.mark.parametrize("dtype,d,fits", [
    (torch.bfloat16, 320, True), (torch.bfloat16, 336, False),
    (torch.float32, 208, True), (torch.float32, 224, False)])
def test_flash_attention_head_dim_limits(dev, no_tf32, dtype, d, fits):
    """The largest head dims whose tiles fit a block's shared memory run
    and match the plain version; the next multiple of 16 is refused by the
    launcher (the wrapper raises, no launch is counted)."""
    from repro_torch.kernels.flash_attention import flash_attention as FA

    qkv = _qkv(dev, 1, 130, 130, 2, 1, d, dtype, d)
    if fits:
        _fa_check(*qkv, causal=True)
        return
    FA.reset_launch_counts()
    with pytest.raises(RuntimeError, match="CUDA error"):
        FA.flash_attention(*qkv)
    assert FA.launch_counts() == {"flash_attention": 0}


# The general route's kernels (flash_attention.cu): float32 register-tiled
# FFMA and bfloat16 mma.sync, one template instance a head-dim band; every
# case forces the general route (a no-op off the sm90 head dims) and checks
# that it ran there.
GENERAL_DIMS = (16, 32, 48, 80, 112, 128, 160, 208, 320)
GENERAL_CASES = {
    "causal": (200, 200, dict(causal=True)),
    "window": (300, 300, dict(causal=True, window=100)),
    "noncausal_ragged": (129, 77, dict(causal=False)),
    "sq_over_sk": (300, 100, dict(causal=True, window=16)),
    "sq_under_sk": (70, 300, dict(causal=False)),
    "empty_k": (70, 0, dict(causal=False)),
}


@pytest.mark.parametrize("dtype,d", [(t, d) for t in (torch.float32, torch.bfloat16)
                                     for d in GENERAL_DIMS
                                     if t == torch.bfloat16 or d <= 208],
                         ids=lambda x: str(x).removeprefix("torch."))
@pytest.mark.parametrize("case", list(GENERAL_CASES))
def test_flash_attention_general_head_dims(dev, no_tf32, dtype, d, case):
    """Head dims across every band of both dtypes (D = 128 in bfloat16 is the
    forced route), causal, causal + window, non-causal with a ragged Sk, Sq
    over and under Sk, and no keys at all (zeros)."""
    from repro_torch.kernels.flash_attention import flash_attention as FA

    sq, sk, kw = GENERAL_CASES[case]
    q, k, v = _qkv(dev, 2, sq, sk, 8, 2, d, dtype, d + sq + sk)
    FA.reset_launch_counts()
    _fa_check(q, k, v, route="general", **kw)
    assert FA.route_counts() == {"general": 1, "sm90": 0}
    if case == "empty_k":
        assert not bool(FA._flash_attention(q, k, v, route="general", **kw).any())
    FA.reset_launch_counts()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=lambda x: str(x).removeprefix("torch."))
def test_flash_attention_general_attributes(dev, dtype):
    """Each band's kernel, at the first and last head dim of every band the
    library reports, as ``cudaFuncGetAttributes`` reads it: a block fits the
    register file, its shared memory fits the SM's 227 KB, and no band
    spills to local memory; the head dim past the last band is refused."""
    from repro_torch.kernels.flash_attention import flash_attention as FA

    tops = FA.general_bands(dtype)
    assert len(tops) >= 1 and list(tops) == sorted(set(tops))
    assert tops[-1] == (320 if dtype == torch.bfloat16 else 208)
    for first, last in zip((16,) + tuple(t + 16 for t in tops[:-1]), tops):
        for d in (first, last):
            a = FA.general_attributes(dtype, d)
            assert 0 < a["registers"] <= 255 and a["registers"] * a["threads"] <= 65536
            assert a["local_bytes"] == 0, (d, a)
            assert 0 < a["static_smem_bytes"] + a["dynamic_smem_bytes"] <= 232448
            assert a["block_k"] in (32, 64) and a["block_q"] in (64, 128)
    with pytest.raises(RuntimeError, match="CUDA error"):
        FA.general_attributes(dtype, tops[-1] + 16)


# The sm90 route (flash_attention_sm90.cu): bfloat16, D in {64, 96, 128,
# 192, 256} (96 runs padded to 128 inside the kernel; 192 and 256 on
# 64-key tiles); each case checks that it ran there (route_counts) and
# holds it to FA_TOL.
SM90_DIMS = (64, 96, 128, 192, 256)


def _sm90_check(q, k, v, **kw):
    from repro_torch.kernels.flash_attention import flash_attention as FA

    assert FA._route_for(q.dtype, q.shape[-1]) == "sm90"
    FA.reset_launch_counts()
    _fa_check(q, k, v, **kw)
    assert FA.route_counts() == {"general": 0, "sm90": 1}
    FA.reset_launch_counts()


@pytest.mark.parametrize("d", SM90_DIMS)
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (4, 1)], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("sq", [1, 127, 128, 129, 200, 300, 4096])
def test_flash_attention_sm90_causal(dev, d, hq, hkv, sq):
    """Causal, Sq = Sk from one row to 4,096, across the 128-row query and
    the key tiles (300: three 128-key tiles, an odd count for the 2-stage
    ring; five 64-key tiles)."""
    b = 1 if sq == 4096 else 2
    _sm90_check(*_qkv(dev, b, sq, sq, hq, hkv, d, torch.bfloat16, sq + d), causal=True)


@pytest.mark.parametrize("d", SM90_DIMS)
@pytest.mark.parametrize("window", [1, 64, 100, 256])
@pytest.mark.parametrize("sq", [129, 1000])
def test_flash_attention_sm90_window(dev, d, window, sq):
    _sm90_check(*_qkv(dev, 2, sq, sq, 8, 2, d, torch.bfloat16, window), causal=True,
                window=window)


@pytest.mark.parametrize("d", SM90_DIMS)
@pytest.mark.parametrize("sq,sk", [(1, 1), (128, 256), (129, 200), (64, 4096), (300, 77),
                                   (200, 300), (77, 640)])
def test_flash_attention_sm90_noncausal_ragged(dev, d, sq, sk):
    """Non-causal with Sq and Sk off the tile grid: ragged key tails masked,
    1 to 64 KV tiles (odd counts for the ring among them)."""
    _sm90_check(*_qkv(dev, 2, sq, sk, 4, 2, d, torch.bfloat16, sq * sk), causal=False)


@pytest.mark.parametrize("d", SM90_DIMS)
def test_flash_attention_sm90_sq_over_sk(dev, d):
    """Sq > Sk, causal with and without a window: rows with no key give 0."""
    from repro_torch.kernels.flash_attention import flash_attention as FA

    q, k, v = _qkv(dev, 1, 300, 100, 4, 2, d, torch.bfloat16, 1)
    _sm90_check(q, k, v, causal=True, window=16)
    _sm90_check(q, k, v, causal=True)
    _sm90_check(q, k, v, causal=False)
    assert not bool(FA.flash_attention(q, k, v, causal=True, window=16)[:, 120:].any())


@pytest.mark.parametrize("d", SM90_DIMS)
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=100),
                                dict(causal=False)], ids=["causal", "window", "noncausal"])
def test_flash_attention_general_route_bf16(dev, d, kw):
    """The general kernel still takes bfloat16 at the sm90 head dims when
    asked to (as chip_smoke.py times it), and agrees at the same tolerance."""
    from repro_torch.kernels.flash_attention import flash_attention as FA

    FA.reset_launch_counts()
    _fa_check(*_qkv(dev, 2, 300, 300, 8, 2, d, torch.bfloat16, d), route="general", **kw)
    assert FA.route_counts() == {"general": 1, "sm90": 0}
    FA.reset_launch_counts()


def test_flash_attention_sm90_empty_keys_and_counts(dev):
    """Sk = 0 gives zeros; route counts add up to the launch count."""
    from repro_torch.kernels.flash_attention import flash_attention as FA

    FA.reset_launch_counts()
    q = torch.randn((2, 70, 4, 128), device=dev).to(torch.bfloat16)
    kv = torch.zeros((2, 0, 2, 128), device=dev, dtype=torch.bfloat16)
    assert not bool(FA.flash_attention(q, kv, kv.clone(), causal=False).any())
    f = torch.randn((1, 64, 2, 128), device=dev)
    FA.flash_attention(f, f.clone(), f.clone())
    assert FA.route_counts() == {"general": 1, "sm90": 1}
    assert FA.launch_counts() == {"flash_attention": 2}
    FA.reset_launch_counts()


@pytest.mark.parametrize("d", SM90_DIMS)
def test_flash_attention_sm90_attributes(dev, d):
    """The loaded kernel's registers, local memory and shared memory at
    each head dim, as ``cudaFuncGetAttributes`` reads them: a block of 256
    threads fits the register file, its shared memory fits the SM's 227 KB;
    a head dim the kernel does not take is refused."""
    from repro_torch.kernels.flash_attention import flash_attention as FA

    a = FA.sm90_attributes(d)
    assert 0 < a["registers"] <= 255 and a["registers"] * 256 <= 65536
    assert a["local_bytes"] >= 0
    assert 0 < a["static_smem_bytes"] + a["dynamic_smem_bytes"] <= 232448
    with pytest.raises(RuntimeError, match="CUDA error"):
        FA.sm90_attributes(d + 16)


def test_smoke_prefill_on_card_launches_per_layer(dev, no_tf32):
    """The qwen3-4b smoke prefill step on the card: one B7 launch per layer,
    last-position logits equal to the CPU run's (float32)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_smoke_config("qwen3_4b"), param_dtype=torch.float32)
    model = Model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    gpu = tree_map(lambda t: t.to(dev), cpu)
    toks = torch.randint(0, cfg.vocab_size, (2, 150), generator=torch.Generator().manual_seed(1))
    step = make_prefill_step(model)
    reset_launch_counts()
    got = step(gpu, {"tokens": toks.to(dev)})
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == cfg.num_layers
    want = step(cpu, {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    reset_launch_counts()


def test_smoke_serve_on_card_equals_cpu(dev, no_tf32):
    """The serve loop on the card gives the CPU run's tokens (float32
    smoke config, the loop's defaults); decode launches no B7."""
    import argparse

    import repro_torch.launch.serve as S
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cfg = dataclasses.replace(get_smoke_config("qwen3_4b"), param_dtype=torch.float32)
    S_get = S.get_smoke_config
    S.get_smoke_config = lambda name: cfg
    try:
        args = dict(arch="qwen3-4b", smoke=True, requests=8, batch=4, max_new=16,
                    max_len=64, seed=0, study=None)
        from repro_torch.models.common import tree_map
        from repro_torch.models.model import Model

        cpu_params = Model(cfg).init(torch.Generator().manual_seed(0))
        reset_launch_counts()
        gpu_out = S.serve(argparse.Namespace(device=str(dev), **args),
                          params=tree_map(lambda t: t.to(dev), cpu_params))
        assert launch_counts()["flash_attention"] == 0
        cpu_out = S.serve(argparse.Namespace(device="cpu", **args), params=cpu_params)
    finally:
        S.get_smoke_config = S_get
    assert [(r.rid, r.out) for r in gpu_out] == [(r.rid, r.out) for r in cpu_out]


@pytest.mark.parametrize("coalesce", [False, True], ids=["one-at-a-time", "coalesced"])
def test_study_server_on_card_equals_cpu(dev, coalesce, monkeypatch):
    """The resident study service on the card answers as on the CPU: the
    same statuses and engines, every row of every answer equal; coalesced,
    each LazyPIM window asks two bloom_query, two bloom_insert and one
    bloom_intersect launches."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import ServeConfig, StudyServer, VirtualClock
    from repro_torch.sim import engine

    windows = []
    inner = engine._lazypim_acc

    def counted(stt, shw, scfg):
        windows.append(stt.num_windows)
        return inner(stt, shw, scfg)

    monkeypatch.setattr(engine, "_lazypim_acc", counted)
    small = dict(num_kernels=3, windows_per_kernel=2)
    spec_a = {"workloads": [{"app": "pagerank", "graph": "arxiv", "scale": 0.4, **small}],
              "mechanisms": ["cpu", "lazypim"], "threads": 16}
    spec_b = {"workloads": [{"app": "htap128", "scale": 0.004, **small}],
              "mechanisms": ["cpu", "lazypim"], "threads": 16,
              "hw_grid": {"offchip_bw_gbs": [16.0, 32.0]}}
    specs = [spec_a, spec_b, spec_a, spec_a, spec_b]
    out = {}
    for device in (str(dev), "cpu"):
        srv = StudyServer(ServeConfig(default_deadline_s=1e9, coalesce=coalesce,
                                      audit_fraction=0.0, device=device),
                          clock=VirtualClock())
        for s in specs:
            srv.submit(s)
        reset_launch_counts()
        windows.clear()
        out[device] = {r.rid: r for r in srv.drain()}
        if device != "cpu":
            counts, walked = launch_counts(), sum(windows)
            assert len(windows) == (2 if coalesce else len(specs))  # LazyPIM dispatches
            assert counts["bloom_query"] == counts["bloom_insert"] == 2 * walked
            assert counts["bloom_intersect"] == walked
    gpu, cpu = out[str(dev)], out["cpu"]
    assert sorted(gpu) == sorted(cpu) == list(range(len(specs)))
    for rid, b in cpu.items():
        a = gpu[rid]
        assert (a.status, a.engine) == (b.status, b.engine) == \
            ("ok", "coalesced" if coalesce else "batch")
        assert a.results.to_rows() == b.results.to_rows(), rid
