"""The reference's public names that the port carries as thin wrappers,
held to ``repro`` on the CPU: the per-mechanism entry points
(``simulate_cpu_only`` ... ``simulate_nc``, ``simulate_lazypim``), the
packed ``ids_member``, ``TRACE_META_FIELDS``, the trace builders
``make_graph_trace`` / ``make_htap_trace`` and the constants
``trace.py`` re-exports.  Traces and every ``SimResult`` field must match
exactly."""

from __future__ import annotations

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.coherence as RC
import repro.core.mechanisms as RM
import repro.sim.prep as RP
import repro.sim.trace as RT
import repro_torch.core.coherence as TC
import repro_torch.core.mechanisms as TM
import repro_torch.sim.prep as TP
import repro_torch.sim.trace as TT
from repro.sim.costmodel import HWParams as RHWParams
from repro_torch.sim.costmodel import HWParams
from repro_torch.sim.engine import run_all

CPU = "cpu"
SMALL = dict(num_kernels=3, windows_per_kernel=2)
MECHS = ("cpu_only", "ideal", "fg", "cg", "nc")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_traces_equal(got, want):
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, (str, int, float)):
            assert a == b, f.name
        else:
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=f.name)


@pytest.fixture(scope="module")
def traces():
    """(reference, port) traces from the two builders at a small size."""
    return {
        "graph": (RT.make_graph_trace("components", "arxiv", scale=0.4, **SMALL),
                  TT.make_graph_trace("components", "arxiv", scale=0.4, device=CPU,
                                      **SMALL)),
        "htap": (RT.make_htap_trace("htap256", scale=0.002, **SMALL),
                 TT.make_htap_trace("htap256", scale=0.002, device=CPU, **SMALL)),
    }


@pytest.fixture(scope="module")
def prepared(traces):
    return {k: (RP.prepare(r), TP.prepare(t, device=CPU)) for k, (r, t) in traces.items()}


def test_names_are_exported():
    assert set(RM.__all__) <= set(TM.__all__)
    assert all(hasattr(TM, name) for name in TM.__all__)
    assert "simulate_lazypim" in TC.__all__ and set(RC.__all__) <= set(TC.__all__)


@pytest.mark.parametrize("kind", ["graph", "htap"])
def test_trace_builders_equal_reference(traces, kind):
    _assert_traces_equal(*traces[kind][::-1])


@pytest.mark.parametrize("fn", ["make_graph_trace", "make_htap_trace"])
def test_trace_builders_keep_reference_defaults(fn):
    """The reference's parameters and defaults, ``backend=`` included (the
    port's ``"torch"`` default names its tensor path, the reference's
    ``"jax"``); ``device=`` is the port's."""
    want = {k: p.default for k, p in inspect.signature(getattr(RT, fn)).parameters.items()}
    got = {k: p.default for k, p in inspect.signature(getattr(TT, fn)).parameters.items()
           if k != "device"}
    assert want["backend"] == "jax" and got["backend"] == "torch"
    assert got == {**want, "backend": "torch"}
    assert inspect.signature(getattr(TT, fn)).parameters["device"].default is None


def test_trace_builders_reject_the_other_family():
    with pytest.raises(ValueError, match="graph app"):
        TT.make_graph_trace("htap128", "arxiv", device=CPU)
    with pytest.raises(ValueError, match="HTAP app"):
        TT.make_htap_trace("pagerank", device=CPU)


def test_reexported_constants_equal_reference():
    for name in ("MAX_SIG_ADDRS", "AR", "AW", "BR", "BW", "APP_CPU_WRITES"):
        assert getattr(TT, name) == getattr(RT, name), name


def test_trace_meta_fields_equal_reference():
    assert TP.TRACE_META_FIELDS == RP.TRACE_META_FIELDS
    assert TP.TRACE_DATA_FIELDS == RP.TRACE_DATA_FIELDS
    fields = {f.name for f in dataclasses.fields(TP.TraceTensors)}
    assert fields == set(TP.TRACE_META_FIELDS) | set(TP.TRACE_DATA_FIELDS)
    assert not set(TP.TRACE_META_FIELDS) & set(TP.TRACE_DATA_FIELDS)


@pytest.mark.parametrize("kind", ["graph", "htap"])
@pytest.mark.parametrize("mech", MECHS)
def test_simulate_baselines_equal_reference(prepared, kind, mech):
    rtt, ttt = prepared[kind]
    hw = dict(thread_cache_cap=64, cpu_only_cache_cap=32)
    want = getattr(RM, f"simulate_{mech}")(rtt, RHWParams(**hw))
    got = getattr(TM, f"simulate_{mech}")(ttt, HWParams(**hw), device=CPU)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("kind", ["graph", "htap"])
@pytest.mark.parametrize("cfg", [{}, dict(partial_commits=False),
                                 dict(use_dbi=False, commit_exposure=0.5)],
                         ids=["default", "full-commit", "no-dbi"])
def test_simulate_lazypim_equals_reference(prepared, kind, cfg):
    rtt, ttt = prepared[kind]
    want = RC.simulate_lazypim(rtt, RHWParams(), RC.LazyPIMConfig(**cfg) if cfg else None)
    got = TC.simulate_lazypim(ttt, HWParams(), TC.LazyPIMConfig(**cfg) if cfg else None,
                              device=CPU)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_wrappers_are_run_all(prepared):
    _, ttt = prepared["graph"]
    every = run_all(ttt, HWParams(), device=CPU)
    for mech, key in zip(MECHS, ("cpu", "ideal", "fg", "cg", "nc")):
        assert getattr(TM, f"simulate_{mech}")(ttt, HWParams(), device=CPU) == every[key]
    assert TC.simulate_lazypim(ttt, HWParams(), device=CPU) == every["lazypim"]
    with pytest.raises(RuntimeError):
        TM.simulate_nc(ttt, HWParams())  # entry points default to the card


@pytest.mark.parametrize("kind", ["graph", "htap"])
def test_ids_member_equals_reference(prepared, kind):
    """Random ids (out-of-range ones clipped, as the reference does),
    random validity, a real image from the trace's first window and a
    random dense one."""
    rtt, ttt = prepared[kind]
    rng = np.random.default_rng(7)
    n = ttt.num_lines
    ids = rng.integers(-3, n + 3, size=300).astype(np.int32)
    valid = rng.random(300) < 0.8
    real = RP.sig_bits_from_ids(rtt, rtt.pim_reads[0], rtt.pim_r_valid[0])
    dense = rng.integers(0, 2**32, size=real.shape, dtype=np.uint64).astype(np.uint32)
    for img in (np.asarray(real), dense):
        want = RP.ids_member(rtt, jnp.asarray(ids), jnp.asarray(valid), jnp.asarray(img))
        got = TP.ids_member(ttt, torch.from_numpy(ids), torch.from_numpy(valid),
                            torch.from_numpy(np.array(img).view(np.int32)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # lanes: two id lists against two images at once
    imgs = np.stack([np.asarray(real), dense]).view(np.int32)
    two = TP.ids_member(ttt, torch.from_numpy(np.stack([ids, ids[::-1].copy()])),
                        torch.from_numpy(np.stack([valid, valid])), torch.from_numpy(imgs))
    for lane, (i, img) in enumerate([(ids, np.asarray(real)), (ids[::-1], dense)]):
        want = RP.ids_member(rtt, jnp.asarray(i), jnp.asarray(valid), jnp.asarray(img))
        np.testing.assert_array_equal(two[lane].numpy(), np.asarray(want))
