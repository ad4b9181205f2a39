"""The port's spans and counters (``repro_torch.models.common.span`` /
``count``) on the CPU: under a profile, a tiny MoE prefill and a tiny dense
training step open every span of the step, the MoE block, the LM head and
AdamW, each inside its step's ``step.*`` span, one ``step.*`` a call carrying
the call's number; with the profiler off no ``record_function`` is entered
and no counter moves; ``moe.pairs_kept`` is the kept set of ``dispatch_plan``
at a capacity that drops pairs and at one that drops none."""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.launch.steps import make_prefill_step, make_train_step
from repro_torch.models import common as C
from repro_torch.models import moe as M
from repro_torch.models.model import Model
from repro_torch.optim import adamw

MOE_SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _fresh_counters():
    C.reset_counters()
    yield
    C.reset_counters()


@pytest.fixture
def entered(monkeypatch):
    """Every (name, args) that ``torch.profiler.record_function`` is called
    with, the real range still opened."""
    calls = []
    real = torch.profiler.record_function

    def spy(name, args=None):
        calls.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    return calls


def _ranges(prof) -> list:
    """(name, start_ns, end_ns, thread) of every ``record_function`` range."""
    return [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]


def _parent(rng, ranges) -> str | None:
    """The innermost other range on the same thread that holds ``rng``."""
    name, s, e, t = rng
    outer = [r for r in ranges if r is not rng and r[3] == t and r[1] <= s and e <= r[2]]
    return max(outer, key=lambda r: r[1])[0] if outer else None


def _moe_prefill(calls: int) -> C.ModelConfig:
    cfg = get_smoke_config("qwen2_moe_a2_7b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    step = make_prefill_step(model)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        for _ in range(calls):
            step(params, {"tokens": tokens})
    return cfg


def _dense_train(calls: int) -> C.ModelConfig:
    cfg = dataclasses.replace(get_smoke_config("phi3_mini_3_8b"), param_dtype=torch.float32,
                              remat=True)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    ocfg = adamw.AdamWConfig(warmup_steps=0)
    state = adamw.init(params, ocfg)
    step = make_train_step(model, ocfg)
    rows = torch.randint(0, cfg.vocab_size, (2, 17), generator=torch.Generator().manual_seed(1))
    for _ in range(calls):
        step(params, state, {"tokens": rows[:, :-1], "labels": rows[:, 1:]})
    return cfg


def test_span_is_one_shared_no_op_with_the_profiler_off():
    assert C.span("a") is C.span("b", 3)


def test_moe_prefill_opens_every_span_inside_its_step(entered):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cfg = _moe_prefill(2)
    ranges = _ranges(prof)
    steps = [r for r in ranges if r[0] == "step.prefill"]
    assert len(steps) == 2
    assert [a for n, a in entered if n == "step.prefill"] == ["0", "1"]
    for name, per_step in [("model.head", 1)] + [(n, cfg.num_layers) for n in MOE_SPANS]:
        mine = [r for r in ranges if r[0] == name]
        assert len(mine) == 2 * per_step, name
        assert {_parent(r, ranges) for r in mine} == {"step.prefill"}, name
        for s in steps:       # each step holds its own share
            assert sum(s[1] <= r[1] and r[2] <= s[2] for r in mine) == per_step, name


def test_dense_train_step_opens_its_spans_inside_its_step(entered):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _dense_train(2)
    ranges = _ranges(prof)
    assert len([r for r in ranges if r[0] == "step.train"]) == 2
    assert [a for n, a in entered if n == "step.train"] == ["0", "1"]
    for name in ("model.head", "adamw.step", "flash_mha.forward", "flash_mha.backward"):
        mine = [r for r in ranges if r[0] == name]
        assert mine, name
        assert {_parent(r, ranges) for r in mine} == {"step.train"}, name
    assert len([r for r in ranges if r[0] == "adamw.step"]) == 2
    assert not any(r[0].startswith("moe.") for r in ranges)


@pytest.mark.parametrize("run", [_moe_prefill, _dense_train], ids=["moe_prefill", "dense_train"])
def test_with_the_profiler_off_nothing_is_entered_or_counted(entered, run):
    run(2)
    assert entered == []
    assert C.counters() == {}
    assert not C._COUNTS


def test_counters_count_only_inside_a_profile_and_keep_device_values_on_device():
    cfg = _moe_prefill(1)
    assert C.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        _moe_prefill(2)
    # the kept pairs add up on the tensors' device, read once by counters()
    assert isinstance(C._COUNTS["moe.pairs_kept"], torch.Tensor)
    got = C.counters()
    t, moe = 2 * 16, cfg.moe
    assert got["moe.pairs_routed"] == 2 * cfg.num_layers * t * moe.top_k
    assert got["moe.rows_computed"] == 2 * cfg.num_layers * moe.num_routed_padded * \
        M.capacity(moe, t)
    assert 0 < got["moe.pairs_kept"] <= got["moe.pairs_routed"]
    C.reset_counters()
    assert C.counters() == {}


@pytest.mark.parametrize("capacity_factor, drops", [(0.5, True), (4.0, False)],
                         ids=["dropping", "dropless"])
@pytest.mark.parametrize("dispatch", ["sort", "cumsum"])
def test_pairs_kept_is_the_dispatch_plans_kept_set(capacity_factor, drops, dispatch):
    base = get_smoke_config("qwen2_moe_a2_7b")
    cfg = dataclasses.replace(base, param_dtype=torch.float32, moe_dispatch=dispatch,
                              moe=dataclasses.replace(base.moe,
                                                      capacity_factor=capacity_factor))
    p = C.init_params(M.moe_param_specs(cfg), torch.Generator().manual_seed(2))
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator().manual_seed(3))
    with profile(activities=[ProfilerActivity.CPU]):
        M.moe_block(p, x, cfg)
    got = C.counters()
    e, t = cfg.moe.num_routed_padded, x.shape[0] * x.shape[1]
    cap = M.capacity(cfg.moe, t)
    _, _, _, _, top_e = M.route(p, x, cfg)
    _, _, rank, _, _ = M.dispatch_plan(top_e, e, dispatch)
    kept = int((rank < cap).sum())
    assert got["moe.pairs_kept"] == kept
    assert got["moe.pairs_routed"] == t * cfg.moe.top_k
    assert got["moe.rows_computed"] == e * cap
    assert (kept < t * cfg.moe.top_k) == drops
