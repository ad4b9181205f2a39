"""Signature specs with more than 32 segments through the whole simulator
on the CPU: the port's ``Study`` with ``SignatureSpec(4096, 64)`` and
``(2048, 64)`` against ``repro``'s on the same traces, all six mechanisms,
both engines, every ``SimResult`` field exact.  ``repro``'s
``SignatureSpec`` takes any M with ``sig_bits`` a multiple of 32 M and a
power-of-two segment; the LazyPIM window's AND-prefilter
(``bloom_intersect``) once refused M > 32 in its argument check, before it
picked the plain path.  The traces are cut to 4 kernels of 2 windows so the
file stays short; the specs are what the test is about."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro.api import SignatureSpec as RSpec
from repro.api import Study as RStudy
from repro.api import workload as r_workload
from repro_torch.api import MECHANISMS, SignatureSpec, Study, workload

SMALL = dict(num_kernels=4, windows_per_kernel=2)
WORKLOADS = (("htap128", None), ("pagerank", "arxiv"))
SPECS = [(4096, 64), (2048, 64)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("engine", ["batch", "sequential"])
@pytest.mark.parametrize("sig_bits,m", SPECS)
def test_many_segments_study_equals_reference(sig_bits, m, engine):
    """One spec on one engine in both packages: every field of 2 x 6
    results equal."""
    r_wl = [r_workload(a, g, **SMALL) for a, g in WORKLOADS]
    want = RStudy(r_wl, spec=RSpec(sig_bits=sig_bits, num_segments=m)).run(
        engine=engine)
    spec = SignatureSpec(sig_bits=sig_bits, num_segments=m)
    wl = [workload(a, g, **SMALL) for a, g in WORKLOADS]
    got = Study(wl, spec=spec, device="cpu").run(engine=engine)
    assert [p.workload for p in got] == [p.workload for p in want]
    for a, b in zip(got, want):
        assert set(a.results) == set(b.results) == set(MECHANISMS)
        for mech in MECHANISMS:
            da = dataclasses.asdict(a.results[mech])
            db = dataclasses.asdict(b.results[mech])
            assert da.keys() == db.keys()
            for k in da:
                assert da[k] == db[k], f"{a.workload}/{mech}/{k}: {da[k]} != {db[k]}"
    assert all(p.results["lazypim"].commits > 0 for p in got)
