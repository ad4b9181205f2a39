"""The port's roofline analysis held against repro on the CPU:
``trace_intensity`` / ``intensity_table`` equal to the reference's on every
field (the paper set, and a capture as in
``tests/test_capture.py::test_roofline_intensity``); the parameter and
FLOP arithmetic (``active_param_count``, ``model_flops``,
``n_periods_equiv``, ``_shallow_cfg``) for all ten archs; the depth
extrapolation of ``analyze_cell`` against a full-depth dry run of a smoke
config, exactly; ``collective_bytes`` on a hand-built DTensor program on a
fake 4 x 4 mesh; and B7's FLOP formula against hand counts."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as r_configs
from repro.roofline import analysis as RA
from repro.sim.trace import make_trace as r_make_trace
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import dryrun as D
from repro_torch.roofline import analysis as A
from repro_torch.sim.trace import make_trace

TINY = dict(num_kernels=3, windows_per_kernel=2, scale=0.05)


@pytest.fixture(scope="module", autouse=True)
def _one_thread_and_teardown():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def test_roofline_intensity():
    """``tests/test_capture.py::test_roofline_intensity`` on the port, and
    every field equal to the reference's on the same capture."""
    prof = A.trace_intensity(make_trace("capture/kv_serve", seed=1, device="cpu", **TINY))
    assert prof["pim_bytes"] > 0 and prof["cpu_bytes"] > 0
    assert prof["lines_touched"] > 0
    assert prof["bytes_per_line_touch"] >= 64.0
    assert prof["pim_instr_per_byte"] > 0
    assert prof == RA.trace_intensity(r_make_trace("capture/kv_serve", seed=1, **TINY))


def test_intensity_table_equals_the_reference():
    """The paper set's rows, the port's traces (its torch backend) against
    the reference's numpy backend (equal to its jax one by its own tests,
    and free of its compile)."""
    kw = dict(num_kernels=4, windows_per_kernel=2)
    got = A.intensity_table(device="cpu", **kw)
    want = RA.intensity_table(backend="ref", **kw)
    assert len(got) == 12
    assert got == want


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_parameter_and_flop_arithmetic_equals_the_reference(arch):
    cfg, rcfg = configs.get_config(arch), r_configs.get_config(arch)
    assert A.active_param_count(cfg) == RA.active_param_count(rcfg)
    assert A.n_periods_equiv(cfg) == RA.n_periods_equiv(rcfg)
    for name in configs.shapes_for(cfg):
        assert A.model_flops(cfg, configs.SHAPES[name]) == \
            RA.model_flops(rcfg, r_configs.SHAPES[name])
    for periods in (1, 2):
        got, want = A._shallow_cfg(cfg, periods), RA._shallow_cfg(rcfg, periods)
        for f in dataclasses.fields(got):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if isinstance(g, torch.dtype):
                assert str(g).removeprefix("torch.") == np.dtype(w).name, f.name
            elif dataclasses.is_dataclass(g):
                assert dataclasses.asdict(g) == dataclasses.asdict(w), f.name
            else:
                assert g == w, f.name


@pytest.mark.parametrize("arch,name", [("qwen3_4b", "train_4k"),
                                       ("falcon_mamba_7b", "prefill_32k")])
def test_analyze_cell_extrapolation_is_exact(arch, name, monkeypatch):
    """A three-layer smoke config: the extrapolation from one and two
    layers equals the full three-layer dry run's counts exactly."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch), num_layers=3)
    monkeypatch.setattr(configs, "get_config", lambda a: cfg)
    got = A.analyze_cell(arch, name)
    full, coll = D.lower_cell(arch, name, cfg_override=dataclasses.replace(cfg, scan_layers=False))
    assert got["flops_dev"] == full["flops"]
    assert got["bytes_dev"] == full["bytes_accessed"]
    assert got["coll_dev"] == coll["total"]
    assert got.keys() == {"arch", "shape", "mesh", "flops_dev", "bytes_dev", "coll_dev",
                          "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                          "model_flops", "hlo_flops_global", "useful_ratio",
                          "roofline_fraction", "coll_by_kind_A"}
    assert got["t_compute_s"] == got["flops_dev"] / 989e12
    assert got["t_memory_s"] == got["bytes_dev"] / 3.35e12
    assert got["t_collective_s"] == got["coll_dev"] / 450e9


def test_collective_bytes_on_a_fake_mesh():
    """Result bytes by kind of a hand-built DTensor program on a 4 x 4
    mesh: each redistribution's collective on one rank's shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = D.fake_mesh((4, 4), ("data", "model"))
    x = DTensor.from_local(torch.zeros(4, 8), mesh, [Shard(0), Shard(1)], run_check=False)
    y = DTensor.from_local(torch.zeros(16, 32), mesh, [Partial(), Replicate()], run_check=False)
    z = DTensor.from_local(torch.zeros(8, 32), mesh, [Replicate(), Partial()], run_check=False)
    with A.collective_bytes() as coll:
        x.redistribute(mesh, [Replicate(), Replicate()])   # (4, 8) -> (16, 8) -> (16, 32)
        y.redistribute(mesh, [Replicate(), Replicate()])   # all-reduce of (16, 32)
        z.redistribute(mesh, [Replicate(), Shard(0)])      # reduce-scatter to (2, 32)
        torch.ones(3) + 1                                   # no collective
    gather = 4.0 * (16 * 8 + 16 * 32)   # either order: 512 + 2,048 bytes
    assert coll == {"all-gather": gather, "all-reduce": 4.0 * 16 * 32,
                    "reduce-scatter": 4.0 * 2 * 32,
                    "total": gather + 4.0 * 16 * 32 + 4.0 * 2 * 32}


@pytest.mark.parametrize("sq,sk,causal,window,pairs", [
    (5, 5, True, 0, 15),          # 1 + 2 + 3 + 4 + 5
    (5, 5, True, 2, 9),           # 1 + 2 + 2 + 2 + 2
    (6, 3, True, 0, 15),          # 1 + 2 + 3 + 3 + 3 + 3
    (4, 7, False, 0, 28),         # cross: every key
    (7, 7, True, 3, 18),          # 1 + 2 + 3 + 3 + 3 + 3 + 3
])
def test_b7_flop_formula_counts_the_keys_each_query_sees(sq, sk, causal, window, pairs):
    b, hq, hkv, d = 2, 4, 2, 16
    assert flash_ops.keys_seen(sq, sk, causal, window) == pairs
    want = 4 * b * hq * d * pairs
    assert flash_ops.flop_count((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d),
                                causal, window) == want
    from torch.utils.flop_counter import FlopCounterMode

    q = torch.randn(b, sq, hq, d)
    k, v = torch.randn(b, sk, hkv, d), torch.randn(b, sk, hkv, d)
    with FlopCounterMode(display=False) as counter:
        flash_ops.mha(q, k, v, causal=causal, window=window)
    assert counter.get_total_flops() == want
