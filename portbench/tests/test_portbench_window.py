"""The window's accounting, with a fake step of known duration."""

import time
import types

import pytest

from portbench import harness as H
from portbench.tests._tiny import CPU

TOKENS = 100


def window(durations, seconds):
    """A window of fake requests; ``durations(i, t)`` is request i's length
    when it starts t seconds into the window."""
    t0 = []

    def call(i):
        now = time.perf_counter()
        if not t0:
            t0.append(now)
        time.sleep(durations(i, now - t0[0]))
        return i

    items, results, _ = H.run_window(call, 10_000, seconds, CPU, False)
    return types.SimpleNamespace(kind="prefill", items=items, results=results,
                                 tokens_per_item=TOKENS)


def metric(name, ctx):
    return H.reader(name)(ctx)


def test_rate_is_work_over_the_span_exactly():
    ctx = window(lambda i, t: 0.01, 0.2)
    span = ctx.items[-1][1] - ctx.items[0][0]
    assert metric("prefill_tokens_per_s", ctx) == len(ctx.items) * TOKENS / span
    assert metric("long_prefill_ms", ctx) == 1e3 * span / len(ctx.items)
    ctx.kind = "train"
    assert metric("train_tokens_per_s", ctx) == len(ctx.items) * TOKENS / span


def test_only_whole_requests_are_counted():
    ctx = window(lambda i, t: 0.1, 0.25)
    # three requests start before the window closes at 0.25 s; the third
    # ends past it and counts whole, and nothing starts after the close
    assert len(ctx.items) == len(ctx.results) == 3
    start = ctx.items[0][0]
    assert all(s < start + 0.25 for s, _ in ctx.items)
    assert ctx.items[-1][1] > start + 0.25
    span = ctx.items[-1][1] - start
    assert span >= 0.3
    assert metric("prefill_tokens_per_s", ctx) == 3 * TOKENS / span


def test_a_stall_mid_window_lowers_the_rate_and_raises_the_p90():
    steady = window(lambda i, t: 0.005, 0.4)
    stalled = window(lambda i, t: 0.03 if 0.1 <= t < 0.3 else 0.005, 0.4)
    assert metric("prefill_tokens_per_s", stalled) < 0.7 * metric("prefill_tokens_per_s", steady)
    assert metric("prefill_p90_ms", stalled) > 3 * metric("prefill_p90_ms", steady)


def test_p90_is_the_90th_percentile_of_every_request():
    ctx = types.SimpleNamespace(kind="prefill", tokens_per_item=TOKENS,
                                items=[(0.0, 0.001 * (i + 1)) for i in range(11)])
    assert metric("prefill_p90_ms", ctx) == pytest.approx(10.0)
