"""The readers of the program's spans and counters: each on a hand-built
trace (device operations, ranges and launches at known intervals) gives the
value computed by hand, and None without its span, as a program without
the spans gives; the tiny cells traced on the CPU give a number for every
ms metric and for the useful-rows share."""

import copy
import json
import time
import types

import pytest
import torch

from portbench import harness as H
from portbench.tests import _tiny
from portbench.trace import WINDOW_RANGE, Trace
from repro_torch.models import common

MS = 1_000_000          # ns
H100 = "NVIDIA H100 80GB HBM3"
CFG_MOE = json.loads((_tiny.TINY / "configs" / "tiny-moe.json").read_text())
CFG_DENSE = json.loads((_tiny.TINY / "configs" / "tiny-dense.json").read_text())


def trace(spans, ops, thread=1):
    """A 100-ms window with ``spans`` [(name, start_ms, end_ms)] on
    ``thread`` and ``ops`` [(launch_ms, start_ms, end_ms)], each launched
    from ``thread`` and run on the device."""
    ranges = [(WINDOW_RANGE, 0, 100 * MS, thread)]
    ranges += [(n, int(s * MS), int(e * MS), thread) for n, s, e in spans]
    device, launches = [], []
    for corr, (at, s, e) in enumerate(ops, start=1):
        launches.append((int(at * MS), thread, corr))
        device.append((f"kernel{corr}", int(s * MS), int(e * MS), corr))
    return Trace(device, [], ranges, launches)


def ctx(kind, tr, cfg=CFG_MOE, items=2):
    return types.SimpleNamespace(kind=kind, trace=tr, cfg=cfg, batch=2, seq=64,
                                 device_kind=H100,
                                 items=[(0.05 * i, 0.05 * (i + 1)) for i in range(items)])


def metric(name, c):
    return H.reader(name)(c)


# (launch, start, end) in ms: two operations under each span, one outside
SPANS = [("model.head", 10, 20), ("model.head", 60, 70),
         ("moe.route", 21, 22), ("moe.dispatch", 22, 23), ("moe.combine", 30, 31),
         ("moe.experts", 24, 29)]
OPS = [(12, 15, 18), (62, 63, 69),                  # head: 3 + 6 ms
       (21.5, 40, 41), (22.5, 41, 43), (30.5, 43, 46),   # glue: 1 + 2 + 3 ms
       (25, 50, 58),                                # experts: 8 ms
       (35, 80, 90)]                                # under no span


def test_head_ms_is_the_device_time_launched_under_the_head_a_request():
    assert metric("head_ms.prefill", ctx("prefill", trace(SPANS, OPS))) == pytest.approx(4.5)


def test_moe_glue_ms_sums_route_dispatch_and_combine_a_request():
    assert metric("moe_glue_ms.prefill", ctx("prefill", trace(SPANS, OPS))) == pytest.approx(3.0)


def test_moe_experts_roofline_is_the_useful_work_over_the_experts_time():
    # tiny-moe: d 64, d_expert 32, top-2 of 8 real experts, 2 layers, 2 x 64 tokens
    flops = 6 * 64 * 32 * 2 * (2 * 64) * 2
    nbytes = 3 * 64 * 32 * 8 * 2 * 2                 # bf16 weights read once a layer
    least = max(flops / 989e12, nbytes / 3.35e12)
    got = metric("moe_experts_roofline.prefill", ctx("prefill", trace(SPANS, OPS)))
    assert got == pytest.approx(100 * least / 4e-3)  # 8 ms over 2 requests


def test_adamw_roofline_is_the_update_bytes_over_the_adamw_time():
    # tiny-dense: 147,456 bf16 elements (embed, head, 2 x (4 attention + 3 MLP)
    # matrices) and 320 float32 (norms): the parameter read and written, the
    # gradient read twice, two float32 moments read and written
    nbytes = 147_456 * (4 * 2 + 4 * 4) + 320 * (4 * 4 + 4 * 4)
    tr = trace([("adamw.step", 10, 20)], [(11, 30, 40), (12, 40, 45)])
    got = metric("adamw_roofline.train", ctx("train", tr, CFG_DENSE))
    assert got == pytest.approx(100 * nbytes / 3.35e12 / 7.5e-3)


def test_idle_ms_is_the_idle_time_inside_the_span_a_step():
    # adamw.step holds [50, 80]: busy [45, 55] + [60, 65] + [78, 90] there
    # for 5 + 5 + 2 ms, so 18 ms idle; step.train holds [0, 48] and [50, 100],
    # busy 3 + 3 + 5 + 5 + 12 + 5 ms there, so 98 - 33 = 65 ms idle
    spans = [("step.train", 0, 48), ("step.train", 50, 100), ("adamw.step", 50, 80)]
    ops = [(1, 2, 5), (5, 45, 55), (52, 60, 65), (55, 78, 90), (90, 95, 100)]
    c = ctx("train", trace(spans, ops), CFG_DENSE)
    assert metric("adamw_idle_ms.train", c) == pytest.approx(9.0)
    assert metric("step_idle_ms.train", c) == pytest.approx(32.5)


def test_useful_rows_is_kept_pairs_over_rows_computed(monkeypatch):
    c = ctx("prefill", trace([], []))
    monkeypatch.setattr(common, "counters", lambda: {
        "moe.pairs_routed": 512, "moe.pairs_kept": 500, "moe.rows_computed": 2048})
    assert metric("moe_useful_rows.prefill", c) == pytest.approx(100 * 500 / 2048)
    monkeypatch.setattr(common, "counters", lambda: {})
    assert metric("moe_useful_rows.prefill", c) is None


NEW = {"prefill": ["head_ms.prefill", "moe_glue_ms.prefill", "moe_experts_roofline.prefill"],
       "train": ["adamw_roofline.train", "adamw_idle_ms.train", "step_idle_ms.train"]}


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_readers_give_none_without_their_spans(kind):
    # the same operations, no program span: a program without the spans
    c = ctx(kind, trace([], OPS), CFG_MOE if kind == "prefill" else CFG_DENSE)
    assert {n: metric(n, c) for n in NEW[kind]} == dict.fromkeys(NEW[kind])
    c.trace = None
    assert {n: metric(n, c) for n in NEW[kind]} == dict.fromkeys(NEW[kind])


# the tiny cells that stand for the benchmark's cells, and what each reads
TINY_CELLS = {"qwen2-moe.prefill_4x4k": "moe.prefill", "phi3-mini.prefill_4x4k": "dense.prefill",
              "phi3-mini.train_1x4k": "dense.train"}
MS_METRICS = {"moe.prefill": ["moe_glue_ms.prefill", "head_ms.prefill"],
              "dense.prefill": ["head_ms.prefill"],
              "dense.train": ["adamw_idle_ms.train", "step_idle_ms.train"]}
ON_CPU = {n for ns in MS_METRICS.values() for n in ns} | {"moe_useful_rows.prefill"}


def tiny_bench() -> dict:
    """The tiny bench with the benchmark's entries of the metrics a CPU
    trace can read, on the tiny cells."""
    bench = copy.deepcopy(_tiny.BENCH)
    real = json.loads((H.ROOT / "BENCHMARK.json").read_text())
    for m in real["per_layer"]:
        if m["name"] in ON_CPU:
            bench["per_layer"].append({**m, "workloads": [TINY_CELLS[w] for w in m["workloads"]]})
    return bench


@pytest.mark.parametrize("workload", sorted(MS_METRICS))
def test_tiny_cells_traced_on_the_cpu_read_every_ms_metric(workload):
    torch.set_num_threads(2)
    common.reset_counters()
    res = H.run_cell(workload, 1, 0.3, True, _tiny.CPU, time.perf_counter(),
                     bench=tiny_bench(), data=_tiny.TINY)
    common.reset_counters()
    got = res["metrics"]
    for name in MS_METRICS[workload]:
        assert got[name]["unit"] == "ms" and got[name]["value"] >= 0.0, name
    if workload == "dense.train":
        # no device operation on the CPU: idle is the spans' time, AdamW's inside the step's
        assert got["step_idle_ms.train"]["value"] > got["adamw_idle_ms.train"]["value"] > 0.0
    if workload == "moe.prefill":
        # tiny-moe at capacity 4.0: 256 pairs a layer in 10 x 102 slots, none dropped
        assert got["moe_useful_rows.prefill"]["value"] == pytest.approx(100 * 256 / 1020)
