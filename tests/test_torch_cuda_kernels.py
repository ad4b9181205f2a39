"""The Bloom CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the main path can produce (ragged line counts, one slot,
empty lanes, pad bits carrying garbage, sign-bit addresses), and one small
end-to-end run held against the CPU path.  Integer results: the tolerance
is exact equality.

These tests need a CUDA device and nvcc; without them they skip.  On the
GPU machine run them with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.core.signatures import (
    SignatureSpec,
    default_spec,
    pack_words,
    tables_tensor,
    unpack_words,
)
from repro_torch.kernels.bloom import bloom as K

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


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s.sig_bits}m{s.num_segments}")
@pytest.mark.parametrize("n", [1, 33, 4097, 262_145])
def test_h3_hash(dev, spec, n):
    tabs = tables_tensor(spec, dev)
    a = torch.randint(-2**31, 2**31 - 1, (n,), generator=_gen(dev, n), device=dev,
                      dtype=torch.int32)
    assert torch.equal(K.h3_hash(a, tabs), K.h3_hash_plain(a, tabs))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s.sig_bits}m{s.num_segments}")
@pytest.mark.parametrize("lanes,slots", [(1, 1), (3, 7), (5, 256), (2, 1000)])
@pytest.mark.parametrize("regs", [1, 16])
def test_insert_ids(dev, spec, lanes, slots, regs):
    tabs = tables_tensor(spec, dev)
    g = _gen(dev, lanes * slots + regs)
    ids = torch.randint(-2**31, 2**31 - 1, (lanes, slots), generator=g,
                        device=dev, dtype=torch.int32)
    valid = torch.rand((lanes, slots), generator=g, device=dev) < 0.6
    ids = torch.where(valid | (torch.rand(ids.shape, generator=g, device=dev) < 0.5),
                      ids, -1)
    kw = dict(ids=ids, valid=valid, num_regs=regs)
    assert torch.equal(K.bloom_insert(tabs, spec.num_words, **kw),
                       K.bloom_insert_plain(tabs, spec.num_words, **kw))


@pytest.mark.parametrize("num_lines", [1, 31, 33, 6409, 262_144])
@pytest.mark.parametrize("density", [0.0, 0.003, 0.3])
@pytest.mark.parametrize("regs", [1, 16])
def test_insert_bitmap(dev, num_lines, density, regs):
    spec = default_spec()
    tabs = tables_tensor(spec, dev)
    nw = (num_lines + 31) // 32
    words = _words((3, nw), density, dev, num_lines)  # pad bits may be set
    kw = dict(bitmap=words, num_lines=num_lines, num_regs=regs)
    assert torch.equal(K.bloom_insert(tabs, spec.num_words, **kw),
                       K.bloom_insert_plain(tabs, spec.num_words, **kw))


@pytest.mark.parametrize("num_lines", [1, 31, 33, 6409, 262_144])
@pytest.mark.parametrize("density", [0.0, 0.003, 0.3])
def test_query(dev, num_lines, density):
    spec = default_spec()
    tabs = tables_tensor(spec, dev)
    nw = (num_lines + 31) // 32
    words = _words((3, nw), density, dev, num_lines)
    sig = _words((3, spec.num_words), 0.4, dev, 7)
    got = K.bloom_query(sig, words, tabs, num_lines)
    assert torch.equal(got, K.bloom_query_plain(sig, words, tabs, num_lines))
    assert not unpack_words(got, nw * 32)[:, num_lines:].any()


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


def test_launch_counts_and_device_checks(dev):
    tabs = tables_tensor(default_spec(), dev)
    K.reset_launch_counts()
    K.h3_hash(torch.arange(10, dtype=torch.int32, device=dev), tabs)
    K.h3_hash(torch.arange(0, dtype=torch.int32, device=dev), tabs)  # no launch
    assert K.launch_counts()["h3_hash"] == 1
    with pytest.raises(ValueError):
        K.h3_hash(torch.arange(10, dtype=torch.int32), tabs)  # mixed devices
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
