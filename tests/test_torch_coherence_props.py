"""The coherence protocol's invariants on the port (CPU), mirroring
``tests/test_coherence_props.py``: no false negatives in signature
membership, a sound AND-prefilter, no missed RAW conflict at trace level
through the bank machinery, LazyPIM never beating the Ideal-PIM bound, and
membership results inside the query bitmap.  Fixtures come from the
port's ``make_graph_trace`` / ``make_htap_trace``, at the reference test's
sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dep: seeded-random fallback (same API subset)
    from _fallback_hypothesis import given, settings, st

from repro_torch.core import signatures as sig
from repro_torch.core.coherence import LazyPIMConfig, simulate_lazypim
from repro_torch.core.mechanisms import simulate_ideal
from repro_torch.sim.costmodel import HWParams
from repro_torch.sim.prep import (
    bank_bits_from_bitmap_bool,
    conflict_any_bool,
    members_bool,
    prepare,
    sig_bits_from_ids_bool,
)
from repro_torch.sim.trace import make_graph_trace, make_htap_trace

CPU = "cpu"
HW = HWParams()
SPEC = sig.SignatureSpec()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _addrs(values) -> torch.Tensor:
    return sig.u32_to_i32(torch.tensor(values, dtype=torch.int64))


# ---------------------------------------------------------------------------
# Signature-level invariants (the protocol's soundness rests on these)
# ---------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 2**31 - 1), min_size=1, max_size=64),
       st.integers(0, 2**31 - 1))
def test_no_false_negatives_membership(addrs, probe):
    s = sig.insert(SPEC, sig.empty_signature(SPEC, CPU), _addrs(addrs))
    assert bool(sig.query(SPEC, s, _addrs(addrs)).all())
    if probe in addrs:
        assert bool(sig.query(SPEC, s, _addrs([probe]))[0])


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 2**20), min_size=1, max_size=100),
       st.lists(st.integers(0, 2**20), min_size=1, max_size=100))
def test_intersection_prefilter_sound(a, b):
    """If the sets share an address, the AND-prefilter must fire (paper
    §5.3: false positives allowed, false negatives never)."""
    sa = sig.insert(SPEC, sig.empty_signature(SPEC, CPU), _addrs(a))
    sb = sig.insert(SPEC, sig.empty_signature(SPEC, CPU), _addrs(b))
    if set(a) & set(b):
        assert bool(sig.intersect_nonempty(SPEC, sa, sb))


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 10_000))
def test_conflict_detection_no_false_negatives_trace_level(seed):
    """An exact RAW conflict (ground truth) implies a signature-detected
    conflict on the same window, across the full bank machinery."""
    rng = np.random.default_rng(seed)
    tr = make_graph_trace("components", "arxiv", threads=16, num_kernels=2,
                          windows_per_kernel=3, seed=seed % 7, scale=0.3, device=CPU)
    tt = prepare(tr, device=CPU)
    w = int(rng.integers(0, tt.num_windows))
    reads, rv = tt.pim_reads[w].numpy(), tt.pim_r_valid[w].numpy()
    cw, cv = tt.cpu_writes[w].numpy(), tt.cpu_w_valid[w].numpy()
    shared = set(reads[rv]) & set(cw[cv])
    bm = np.zeros((1, tt.num_lines), bool)
    bm[0, cw[cv]] = True
    bank = bank_bits_from_bitmap_bool(tt, torch.from_numpy(bm))
    rbits = sig_bits_from_ids_bool(tt, tt.pim_reads[w:w + 1], tt.pim_r_valid[w:w + 1])
    if shared:
        assert bool(conflict_any_bool(tt, rbits, bank)[0])


def test_lazypim_never_slower_than_serialized_bound():
    """LazyPIM's time and traffic are at least Ideal's (speculation cannot
    beat the no-coherence upper bound)."""
    for app, g in (("pagerank", "arxiv"), ("htap128", None)):
        tr = (make_graph_trace(app, g, threads=16, device=CPU) if g
              else make_htap_trace(app, threads=16, device=CPU))
        tt = prepare(tr, device=CPU)
        lz = simulate_lazypim(tt, HW, LazyPIMConfig(), device=CPU)
        ideal = simulate_ideal(tt, HW, device=CPU)
        assert lz.time_ns >= ideal.time_ns
        assert lz.offchip_bytes >= ideal.offchip_bytes


@settings(max_examples=10, deadline=None)
@given(st.integers(2, 5))
def test_members_subset_of_bitmap(k):
    """Signature membership results are a subset of the query bitmap
    (flushes only touch lines that exist)."""
    tr = make_htap_trace("htap128", threads=4, num_kernels=2, windows_per_kernel=2,
                         scale=0.005, device=CPU)
    tt = prepare(tr, device=CPU)
    rng = np.random.default_rng(k)
    bm = torch.from_numpy(rng.random((1, tt.num_lines)) < 0.01)
    bits = sig_bits_from_ids_bool(tt, tt.pim_reads[0:1], tt.pim_r_valid[0:1])
    m = members_bool(tt, bm, bits)
    assert bool((~m | bm).all())
