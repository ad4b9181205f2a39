"""``capture/moe_experts`` (repro_torch.capture.moe_experts) held against
repro.capture.moe_experts on the CPU: ``MoEExpertsConfig`` (``scaled``,
``cap``, ``layout``), the router / embedding parameters — the reference's
``jax.random.normal`` draws, regenerated bit for bit by
:mod:`repro_torch.sim._jaxrandom` (keys, ``split``, XLA's float32
``log1p`` and ``erf_inv``, each against JAX on 10^6 values) — and the
trace on every ``WindowTrace`` field at scale 0.05 and 1.0, seeds 0-2.
The trace depends on the parameters only through the integer routing, so
each of those runs also asserts the routing margin: the smallest relative
gap between adjacent gates among each token's top k + 1 stays hundreds of
float32 ulps wide, so a different summation order of the router product
(the card's, the CPU's) cannot move an expert — equality is shown, not
lucky.  Then the port's mirror of ``tests/test_trace_props.py::
test_capture_trace_invariants`` over the three captured families, a
``Study`` on all three on both engines (every field equal to repro's) and
the study service's admission of them (``tests/test_capture.py::
test_serve_admission``)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.capture import moe_experts as RME
from repro.sim.trace import make_trace as r_make_trace
from repro_torch.capture import MoEExpertsConfig, capture_moe_experts, capture_trace
from repro_torch.capture import moe_experts as ME
from repro_torch.capture.kv_serve import KVServeConfig
from repro_torch.capture.lazy_embed import LazyEmbedConfig
from repro_torch.sim import _jaxrandom as JR
from repro_torch.sim.prep import bucket_bound
from repro_torch.sim.synth import MAX_SIG_ADDRS
from repro_torch.sim.trace import CAPTURE_APPS, make_trace

APP = "capture/moe_experts"
# a gap of 256 float32 ulps (relative): ~10x the rounding of a 64-term
# float32 dot product at these magnitudes
MIN_GATE_GAP = 256 * 2.0 ** -23


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _assert_same_trace(r, t):
    for f in dataclasses.fields(r):
        a, b = getattr(r, f.name), getattr(t, f.name)
        if isinstance(b, torch.Tensor):
            assert b.device.type == "cpu", f.name
            b = b.numpy()
            a = np.asarray(a)
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert a == b, f.name


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [0.05, 0.25, 1.0, 2.0])
def test_config_matches_reference(scale):
    t, r = MoEExpertsConfig.scaled(scale), RME.MoEExpertsConfig.scaled(scale)
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert t.cap == r.cap
    lt, lr = t.layout(), r.layout()
    assert (lt.num_lines, lt.natural_lines) == (lr.num_lines, lr.natural_lines)
    assert [dataclasses.astuple(x) for x in lt.regions] == \
        [dataclasses.astuple(x) for x in lr.regions]
    assert lt.num_lines == bucket_bound(lt.num_lines)
    assert MoEExpertsConfig().cap == max(8, int(1.25 * 64 * 2 / 32)) == 8


# ---------------------------------------------------------------------------
# The reference's jax.random draws without JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 12345, 2**32 - 1])
def test_keys_and_split_match_jax(seed):
    k = jax.random.key(seed)
    assert JR.key(seed) == tuple(np.asarray(jax.random.key_data(k)))
    for num in (2, 3):
        want = np.asarray(jax.random.key_data(jax.random.split(k, num)))
        assert [tuple(x) for x in want] == JR.split(JR.key(seed), num)
    with pytest.raises(ValueError, match="seed"):
        JR.key(-1)


def test_log1p_and_erf_inv_match_xla_bit_for_bit():
    """XLA's float32 ``log1p`` (10^6 values over its two branches and
    beyond) and ``erf_inv`` (10^6 values in [-1, 1)); numpy's ``log1p``
    differs on a share of them, which is why the copy exists."""
    rng = np.random.default_rng(0)
    x = np.concatenate([-rng.random(600_000, dtype=np.float32),
                        (rng.random(200_000, dtype=np.float32) - 0.5) * 0.9,
                        rng.random(200_000, dtype=np.float32) * 20,
                        np.array([0.0, -0.0, 1e-30, -1.0, np.inf], np.float32)])
    want = np.asarray(jnp.log1p(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(JR.log1p(x)), _bits(want))
    with np.errstate(divide="ignore"):
        assert (np.log1p(x) != want).mean() > 1e-3
    u = rng.random(1_000_000, dtype=np.float32) * 2 - 1
    u[:3] = (-1.0, 0.0, np.nextafter(np.float32(-1), np.float32(0)))
    np.testing.assert_array_equal(_bits(JR.erf_inv(u)),
                                  _bits(jax.lax.erf_inv(jnp.asarray(u))))


@pytest.mark.parametrize("seed,shape", [(0, (1000, 1000)), (1, (64, 32)), (2, (33, 7)),
                                        (5, (8,))])
def test_normal_matches_jax_bit_for_bit(seed, shape):
    k = jax.random.split(jax.random.key(seed))[1]
    want = jax.random.normal(k, shape, dtype="float32")
    got = JR.normal(JR.split(JR.key(seed))[1], shape)
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("d,e,v,seed", [(64, 32, 512, 0), (8, 4, 32, 1), (16, 8, 128, 2),
                                        (128, 64, 1024, 0)])
def test_params_match_reference_bit_for_bit(d, e, v, seed):
    router, emb = ME._params(d, e, v, seed)
    r_router, r_emb = RME._params(d, e, v, seed)
    np.testing.assert_array_equal(_bits(router), _bits(r_router))
    np.testing.assert_array_equal(_bits(emb), _bits(r_emb))
    assert not router.flags.writeable and not emb.flags.writeable


# ---------------------------------------------------------------------------
# The trace against repro, with the routing margin
# ---------------------------------------------------------------------------


def _recorded_route(monkeypatch):
    """Wrap the adapter's route so every call's float32 inputs are kept."""
    calls = []
    route = ME._route

    def recorded(emb_rows, router, bias, k):
        calls.append((emb_rows.numpy().copy(), router.numpy().copy(),
                      bias.numpy().copy(), k))
        return route(emb_rows, router, bias, k)

    monkeypatch.setattr(ME, "_route", recorded)
    return calls


def _min_gate_gap(calls) -> float:
    """Smallest relative gap between adjacent gates among each token's top
    k + 1, over every route call (float64 gates from the float32 inputs)."""
    gap = np.inf
    for emb_rows, router, bias, k in calls:
        logits = emb_rows.astype(np.float64) @ router.astype(np.float64) + bias
        g = np.exp(logits - logits.max(-1, keepdims=True))
        g = -np.sort(-g / g.sum(-1, keepdims=True), axis=-1)[:, :k + 1]
        gap = min(gap, float(((g[:, :-1] - g[:, 1:]) / g[:, :-1]).min()))
    return gap


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scale", [0.05, 1.0])
def test_capture_matches_reference(monkeypatch, scale, seed):
    calls = _recorded_route(monkeypatch)
    t = capture_moe_experts(seed=seed, scale=scale, device="cpu")
    _assert_same_trace(RME.capture_moe_experts(seed=seed, scale=scale), t)
    assert t.name == APP and t.num_kernels == 24
    assert len(calls) == 24 * 3
    gap = _min_gate_gap(calls)
    assert gap > MIN_GATE_GAP, f"routing margin {gap:.3g} too thin to show equality"


def test_make_trace_and_capture_trace_match_reference():
    kw = dict(seed=1, num_kernels=5, windows_per_kernel=2, scale=0.25)
    _assert_same_trace(r_make_trace(APP, **kw), make_trace(APP, device="cpu", **kw))
    t = capture_trace(APP, cpu_reuse=4.0, device="cpu", **kw)
    assert t.cpu_reuse == 4.0
    _assert_same_trace(r_make_trace(APP, cpu_reuse=4.0, **kw), t)
    assert make_trace(APP, device="cpu", num_kernels=2).cpu_reuse == 6.0
    with pytest.raises(ValueError, match="graph_name must be None"):
        make_trace(APP, "enron", device="cpu")


def test_capture_routes_through_the_model_zoo(monkeypatch):
    """The adapter's routing is ``models.moe._routing`` and the block's
    cumsum rank helper: replacing the helper changes the trace."""
    from repro_torch.models import moe as M

    seen = []
    rank = M.cumsum_rank

    def counted(top_e, e):
        seen.append(tuple(top_e.shape))
        return rank(top_e, e)

    monkeypatch.setattr(ME, "cumsum_rank", counted)
    capture_moe_experts(seed=0, scale=0.05, num_kernels=2, windows_per_kernel=2,
                        device="cpu")
    assert seen == [(8, 2)] * 4


def test_capture_defaults_to_cuda():
    if torch.cuda.is_available():
        assert make_trace(APP, num_kernels=2).pim_reads.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_trace(APP, num_kernels=2)


# ---------------------------------------------------------------------------
# Trace invariants over the captured families (tests/test_trace_props.py)
# ---------------------------------------------------------------------------


def _natural_lines(app: str) -> int:
    cfg = {"capture/kv_serve": KVServeConfig,
           "capture/moe_experts": MoEExpertsConfig,
           "capture/lazy_embed": LazyEmbedConfig}[app].scaled(0.05)
    return cfg.layout().natural_lines


def _small_capture(app: str, seed: int):
    return make_trace(app, seed=seed, num_kernels=3, windows_per_kernel=2, scale=0.05,
                      device="cpu")


@pytest.mark.parametrize("seed", [0, 4321, 65536])
@pytest.mark.parametrize("app", CAPTURE_APPS)
def test_capture_trace_invariants(app, seed):
    """Sentinel correctness, the §5.4 insert cap, pre-write / pad
    disjointness and fixed-seed determinism, on each captured family."""
    tr = _small_capture(app, seed)
    n = tr.num_lines
    natural = _natural_lines(app)
    assert n == bucket_bound(n), "captured trace leaked a ragged geometry"
    for name in ("pim_reads", "pim_writes", "cpu_reads", "cpu_writes"):
        ids = getattr(tr, name).numpy()
        assert ids.dtype == np.int32, name
        assert np.all((ids == -1) | ((ids >= 0) & (ids < n))), name
        assert np.all(ids < natural), f"{name}: access in the padded region"
    for name in ("pim_reads", "pim_writes"):
        for row in getattr(tr, name).numpy():
            assert len(np.unique(row[row >= 0])) <= MAX_SIG_ADDRS, name
    pre = tr.pre_writes.numpy()
    assert pre.shape == (tr.num_kernels, n) and pre.dtype == bool
    assert pre.any(axis=1).all(), "a kernel with an empty inter-kernel phase"
    assert not pre[:, natural:].any(), "pre-write set in the padded region"
    kid = tr.kernel_id.numpy()
    assert kid.min() == 0 and kid.max() == tr.num_kernels - 1
    assert int(tr.kernel_start.sum()) == int(tr.kernel_end.sum()) == tr.num_kernels
    again = _small_capture(app, seed)
    for name in ("pim_reads", "pim_writes", "cpu_reads", "cpu_writes",
                 "pre_writes", "pim_instr", "cpu_instr"):
        assert torch.equal(getattr(tr, name), getattr(again, name)), name


# ---------------------------------------------------------------------------
# Study and the study service on the three captured apps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["batch", "sequential"])
def test_study_on_the_captured_fleet_matches_reference(engine):
    """The three captured apps at their default scale, 8 kernels each (the
    24-kernel study runs on the card in ``chip_smoke.py``, against this
    CPU path)."""
    from repro.api import Study as RStudy
    from repro.api import workload as r_workload
    from repro_torch.api import Study, workload

    got = Study([workload(a, num_kernels=8) for a in CAPTURE_APPS],
                device="cpu").run(engine=engine)
    want = RStudy([r_workload(a, num_kernels=8) for a in CAPTURE_APPS]).run(engine=engine)
    assert [p.workload for p in got] == [p.workload for p in want] == list(CAPTURE_APPS)
    for a, b in zip(got.points, want.points):
        assert set(a.results) == set(b.results)
        for m in b.results:
            assert dataclasses.asdict(a.results[m]) == dataclasses.asdict(b.results[m]), m


def test_study_and_service_admit_the_captured_apps():
    from repro_torch.api import Study
    from repro_torch.serve.request import build_study

    assert list(Study(list(CAPTURE_APPS), device="cpu").workloads) == list(CAPTURE_APPS)
    study = build_study({"workloads": list(CAPTURE_APPS),
                         "mechanisms": ["cpu", "lazypim"], "threads": 16}, device="cpu")
    assert len(study.workloads) == 3
    with pytest.raises(ValueError, match="unknown capture spec"):
        build_study({"workloads": ["capture/bogus"]}, device="cpu")
