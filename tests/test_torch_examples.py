"""The port's five examples (``examples/torch_*.py``) on the CPU at a small
size, each held to the reference library calls its reference example makes
at that size: the quickstart's and the study grid's results on every field
(and the plan, the pivot, the signature verdicts), the lazy demo's conflict
counts and byte totals exactly, the trainer's model against the reference
model and its failure / restart, and the serving demo's token loop and
storm.  Each example refuses to start without a card unless given
``--device cpu``."""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LazyPIMConfig as RLazyPIMConfig
from repro.api import Study as RStudy
from repro.api import grid as r_grid
from repro.api import workload as r_workload

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
NAMES = ("torch_quickstart", "torch_study_grid", "torch_lazy_coherence_demo",
         "torch_serve_batched", "torch_train_100m")
SIZE = ["--scale", "0.004", "--num-kernels", "3", "--windows-per-kernel", "2"]
SMALL = dict(scale=0.004, num_kernels=3, windows_per_kernel=2)


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def assert_points_equal(got, want):
    assert len(got.points) == len(want.points)
    for a, b in zip(got.points, want.points):
        assert (a.workload, a.hw_index, a.lazy_index) == (b.workload, b.hw_index, b.lazy_index)
        assert a.results.keys() == b.results.keys()
        for m in a.results:
            assert dataclasses.asdict(a.results[m]) == dataclasses.asdict(b.results[m]), \
                (a.workload, m)


@pytest.mark.parametrize("name", NAMES)
def test_example_refuses_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is legitimate here")
    argv = {"torch_train_100m": ["--steps", "2", "--layers", "1"]}.get(name, [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load(name).main(argv)


def test_quickstart_equals_reference():
    from repro.core.signatures import SignatureSpec, empty_signature
    from repro.kernels.bloom import bloom_insert, bloom_intersect

    out = load("torch_quickstart").main(["--device", "cpu", *SIZE])
    ref = RStudy(workloads=[r_workload("pagerank", "arxiv", **SMALL),
                            r_workload("htap128", **SMALL)]).run()
    assert_points_equal(out["results"], ref)
    assert out["normalized"] == ref.normalized()
    spec = SignatureSpec()

    def sig(ids):
        return bloom_insert(spec, empty_signature(spec), jnp.asarray(ids, jnp.uint32))

    reads = sig(np.arange(100, 200))
    for key, other in (("conflict_overlapping", [150]), ("conflict_disjoint", [5000])):
        assert out[key] == bool(bloom_intersect(spec, reads[None], sig(other)[None])[0])
    assert (out["conflict_overlapping"], out["conflict_disjoint"]) == (True, False)


def test_study_grid_equals_reference():
    out = load("torch_study_grid").main(["--device", "cpu", *SIZE])
    study = RStudy(workloads=[r_workload("pagerank", "arxiv", **SMALL)],
                   hw=r_grid(offchip_bw_gbs=[16.0, 32.0, 64.0]),
                   mechanisms=("cpu", "cg", "lazypim"),
                   lazy=[RLazyPIMConfig(use_dbi=True), RLazyPIMConfig(use_dbi=False)])
    plan, ref = study.plan(), study.run()
    assert out["plan"].num_buckets == plan.num_buckets
    assert out["plan"].compiles_per_mechanism == plan.compiles_per_mechanism
    assert_points_equal(out["results"], ref)
    assert out["table"] == ref.pivot(("hw_index", "lazy_index"), "mechanism", "speedup")
    lz = [p for p in ref.points if p.hw_index == 0]
    assert out["dbi_writebacks"] == tuple(p.results["lazypim"].dbi_writebacks for p in lz)


def test_lazy_demo_counts_equal_reference():
    """The reference demo's loop through ``repro``'s LazyEmbed: every
    step's conflict rows, commit flag and bytes, and both totals, exact."""
    from repro.configs import get_smoke_config
    from repro.core.lazy_sync import LazyEmbed, LazySyncConfig, init_state

    steps = 8
    out = load("torch_lazy_coherence_demo").main(["--device", "cpu", "--steps", str(steps)])
    mcfg = get_smoke_config("qwen3_4b")
    cfg = LazySyncConfig(num_groups=4, commit_interval=8, max_reconcile_rows=128)
    emb = LazyEmbed(mcfg, cfg)
    params = emb.init(jax.random.key(0))
    state = init_state(cfg, mcfg.vocab)
    key = jax.random.key(1)
    want, tot_lazy, tot_dense = [], 0.0, 0.0
    for _ in range(steps):
        key, k1, k2 = jax.random.split(key, 3)
        touched = jax.random.randint(k1, (cfg.num_groups, 48), 0, mcfg.vocab // 4,
                                     dtype=jnp.int32)
        g = jax.random.normal(k2, touched.shape + (mcfg.d_model,)) * 0.05
        grads = jnp.zeros((cfg.num_groups, mcfg.vocab, mcfg.d_model))
        grads = grads.at[jnp.arange(cfg.num_groups)[:, None], touched].add(g)
        params, state, m = emb.sync_step(params, state, touched, grads)
        want.append({"conflicts": int(m["lazy_conflict_rows"]),
                     "commit": bool(m["lazy_commit"]),
                     "lazy_bytes": float(m["lazy_bytes"]),
                     "dense_bytes": float(m["dense_bytes"])})
        tot_lazy += float(m["lazy_bytes"])
        tot_dense += float(m["dense_bytes"])
    assert out["steps"] == want
    assert (out["lazy_bytes"], out["dense_bytes"]) == (tot_lazy, tot_dense)
    assert any(r["commit"] for r in want) and any(r["conflicts"] for r in want)


def test_train_100m_model_and_restart_match_reference():
    """The trainer at one layer: the reference's model (parameter tree and
    count at that depth), finite losses from about ln(vocab), and the
    reference run's failure rule (fail at half the steps, no checkpoint
    before step 50, so the restart starts over and runs every step).  The
    loss falling is held on the card, at 600 steps of the full model
    (``chip_smoke.py``)."""
    from repro.models.common import ModelConfig as RModelConfig
    from repro.models.model import Model as RModel

    mod = load("torch_train_100m")
    out = mod.main(["--device", "cpu", "--steps", "4", "--batch", "1", "--seq", "16",
                    "--layers", "1"])
    rcfg = RModelConfig(name="qwen3-100m", family="dense", num_layers=1, d_model=512,
                        num_heads=8, num_kv_heads=4, head_dim=64, d_ff=2048,
                        vocab_size=16_384, qk_norm=True, remat=False)
    rmodel = RModel(rcfg)
    assert out["params"] == rmodel.param_count()
    want = jax.tree_util.tree_map(lambda s: tuple(s.shape), rmodel.param_specs(),
                                  is_leaf=lambda s: hasattr(s, "shape"))
    ours = mod.Model(mod.model_100m(1)).param_specs()
    flat_w = jax.tree_util.tree_leaves_with_path(want, is_leaf=lambda s: isinstance(s, tuple))
    assert len(flat_w) == len(jax.tree_util.tree_leaves(
        ours, is_leaf=lambda s: hasattr(s, "shape")))
    assert abs(out["first_loss"] - np.log(16_384)) < 0.3
    assert out["restored_step"] is None and len(out["losses"]) == 4
    assert all(np.isfinite(out["losses"]))


def test_serve_batched_equals_reference():
    """The token loop's requests (prompts, new-token counts, finish order)
    equal the reference serve loop's; the storm's specs equal the
    reference's ``make_storm``; every study request ends terminal, none
    crashed, and every served answer equals a direct run of its spec."""
    from repro.launch.serve import serve as r_serve
    from repro.serve import ChaosConfig as RChaosConfig
    from repro.serve import ChaosMonkey as RChaosMonkey
    from repro.serve import make_storm as r_make_storm
    from repro_torch.serve import ChaosConfig, ChaosMonkey, build_study, make_storm

    mod = load("torch_serve_batched")
    storm = 8
    out = mod.main(["--device", "cpu", "--storm", str(storm)])
    ref = r_serve(argparse.Namespace(arch="qwen3-4b", smoke=True, requests=6, batch=3,
                                     max_new=8, max_len=48, seed=0))
    assert [(r.rid, r.prompt, len(r.out) - len(r.prompt)) for r in out["served"]] == \
        [(r.rid, r.prompt, len(r.out) - len(r.prompt)) for r in ref]
    specs = make_storm(ChaosMonkey(ChaosConfig(seed=2, fault_rate=0.25, hang_s=5.0)),
                       storm, mod.SPECS)
    assert specs == r_make_storm(RChaosMonkey(RChaosConfig(seed=2, fault_rate=0.25,
                                                            hang_s=5.0)), storm, mod.SPECS)
    assert sorted(out["responses"]) == list(range(storm))
    for rid, r in out["responses"].items():
        assert r.status != "crashed", rid
        if r.served:
            want = build_study(specs[rid], device="cpu").run()
            assert r.results.to_rows() == want.to_rows(), rid
