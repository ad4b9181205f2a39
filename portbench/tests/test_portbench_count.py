"""The frozen count against figures the records already state, and the
trace arithmetic the per-layer readers use."""

import json
from pathlib import Path

import pytest

from portbench.metrics import _count
from portbench.trace import WINDOW_RANGE, Trace

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
PHI3 = json.loads((CONFIGS / "phi3-mini-3.8b.json").read_text())
QWEN = json.loads((CONFIGS / "qwen2-moe-a2.7b.json").read_text())


def test_phi3_layer0_b7_call_is_4_124e11_flop():
    # (4, 4,096, 32 on 32, 96) causal: 4 * 96 * 8,390,656 pairs * 4 rows * 32 heads
    assert _count.causal_pairs(4096) == 8_390_656
    one_layer = _count.attention_flops(PHI3, 4, 4096) / PHI3["num_hidden_layers"]
    assert one_layer == 4 * 96 * 8_390_656 * 4 * 32
    assert one_layer == pytest.approx(4.124e11, rel=1e-3)


def test_head_dim_is_counted_unpadded():
    assert _count.dims(PHI3)["head_dim"] == 96
    bytes_ = _count.attention_bytes(PHI3, 4, 4096) / 32
    assert bytes_ == 2 * 4 * 4096 * 96 * (2 * 32 + 2 * 32)


def test_prefill_counts_the_head_once_a_row():
    b, s = 4, 4096
    head = 2 * 3072 * 32064
    want = b * s * _count.block_flops_per_token(PHI3) + _count.attention_flops(PHI3, b, s) \
        + b * head
    assert _count.head_flops(PHI3) == head
    assert _count.prefill_flops(PHI3, b, s) == want


def test_training_backward_is_2_5_times_the_forward_with_no_recompute():
    b, s = 1, 4096
    attn = _count.attention_flops(PHI3, b, s)
    assert _count.train_attention_flops(PHI3, b, s) == 3.5 * attn
    weights = b * s * (_count.block_flops_per_token(PHI3) + _count.head_flops(PHI3))
    assert _count.train_flops(PHI3, b, s) == 3 * weights + 3.5 * attn


@pytest.mark.parametrize("cfg,b,s,gflop_a_token", [
    (PHI3, 4, 4096, 8.06), (PHI3, 1, 32768, 13.69), (QWEN, 4, 4096, 4.54)])
def test_useful_work_a_token(cfg, b, s, gflop_a_token):
    assert _count.prefill_flops(cfg, b, s) / (b * s) / 1e9 == pytest.approx(gflop_a_token,
                                                                               abs=0.01)


def test_moe_counts_top_k_of_the_real_experts_and_the_shared_one():
    m = _count.dims(QWEN)
    per_layer = (2 * 2048 * 128 * (4 * 16) + 2 * 2048 * 60 + 6 * 2048 * 1408 * 4
                 + 6 * 2048 * 5632)
    assert m["experts"] == 60 and m["top_k"] == 4
    assert _count.block_flops_per_token(QWEN) == 24 * per_layer


def test_roofline_takes_the_larger_bound_and_unknown_devices_have_no_peak():
    peak = _count.peaks("NVIDIA H100 80GB HBM3")
    assert _count.roofline_s(989e12, 0, peak) == pytest.approx(1.0)
    assert _count.roofline_s(0, 3.35e12, peak) == pytest.approx(1.0)
    assert _count.peaks("cpu") is None


def _trace():
    ms = 1_000_000
    device = [("gemm", 10 * ms, 20 * ms, 1), ("gemm", 15 * ms, 30 * ms, 2),
              ("flash_attention_sm90", 40 * ms, 60 * ms, 3), ("copy", 95 * ms, 120 * ms, 4)]
    host = [("aten::mm", 0, 30 * ms, 7), ("cudaLaunchKernel", 32 * ms, 33 * ms, 7),
            ("aten::add", 59 * ms, 80 * ms, 7)]
    ranges = [(WINDOW_RANGE, 0, 100 * ms, 7), ("flash_mha.forward", 31 * ms, 35 * ms, 7)]
    launches = [(9 * ms, 7, 1), (14 * ms, 7, 2), (32 * ms, 7, 3), (90 * ms, 7, 4)]
    return Trace(device, host, ranges, launches)


def test_trace_busy_is_the_union_of_device_intervals_inside_the_window():
    t = _trace()
    assert t.window_s == pytest.approx(0.1)
    # [10, 30] + [40, 60] + [95, 100] (clipped) ms
    assert t.busy_s == pytest.approx(0.045)
    assert t.device_s_named("flash_attention") == pytest.approx(0.02)
    assert t.device_s_under(("flash_mha.forward",)) == pytest.approx(0.02)


def test_trace_breakdown_names_the_longest_gaps_by_host_activity():
    t = _trace()
    gaps = t.idle_gaps(10)
    assert gaps[0] == ["aten::add", pytest.approx(0.035)]
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)
    assert sum(g[1] for g in gaps) == pytest.approx(t.window_s - t.busy_s)
    assert t.top_device_ops(2)[0] == ["gemm", pytest.approx(0.025)]
