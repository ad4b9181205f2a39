"""The port's dry run held against repro on the CPU: the shape cells
(``SHAPES``, ``shapes_for``, ``all_cells``); the dry-run inputs
(``Model.input_specs``, ``frontend_spec``, ``adamw.abstract_state``) for
every arch x applicable shape at full width, as meta tensors; the local
shard shape of every parameter leaf, batch input and decode-cache leaf of
all ten full-width archs under each production rule set, against
``NamedSharding(AbstractMesh(...), spec).shard_shape`` (no devices); and
``lower_cell`` on smoke configs on the fake (16, 16) and (2, 16, 16)
meshes, whose argument bytes must equal the sum of those shard bytes.  On
a one-rank mesh the dry run's FLOPs equal ``FlopCounterMode``'s count of
the same step run on plain fake tensors.

The fake process group is global to the process: the module's fixture
starts it and tears it down."""

from __future__ import annotations

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as r_configs
from repro.launch import steps as r_steps
from repro.models import common as RC
from repro.models import frontends as r_frontends
from repro.models.model import Model as RModel
from repro.optim import adamw as r_adamw
from repro_torch import configs
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import steps
from repro_torch.models import common as C
from repro_torch.models import frontends
from repro_torch.models.model import Model
from repro_torch.optim import adamw

RULE_SETS = [(False, False), (True, False), (True, True)]   # (multi_pod, fsdp_pod)


@pytest.fixture(scope="module", autouse=True)
def _one_thread_and_teardown():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _flat(tree, is_leaf=None, path=()) -> dict:
    """{path: leaf} of a tree of dicts, lists and tuples."""
    if is_leaf is not None and is_leaf(tree):
        return {path: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, is_leaf, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, is_leaf, path + (i,)))
        return out
    return {path: tree}


def _is_placements(x) -> bool:
    return isinstance(x, tuple) and bool(x) and all(hasattr(p, "is_shard") for p in x)


def _is_sds(x) -> bool:
    return isinstance(x, jax.ShapeDtypeStruct) or x is None


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else np.dtype(dt).name


def _same_specs(got: dict, want: dict) -> None:
    got, want = _flat(got), _flat(want, _is_sds)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if w is None:
            assert g is None, k
            continue
        assert tuple(g.shape) == tuple(w.shape), k
        assert _dtype_name(g.dtype) == _dtype_name(w.dtype), k


def _meshes(multi_pod: bool):
    shape, names = launch_mesh.production_shape(multi_pod)
    return C.AbstractMesh(shape, names), jax.sharding.AbstractMesh(shape, names)


def _rules(multi_pod: bool, fsdp_pod: bool) -> dict:
    names = launch_mesh.production_shape(multi_pod)[1]
    return launch_mesh.rules_for(C.AbstractMesh((1,) * len(names), names), fsdp_pod=fsdp_pod)


def test_shape_cells_equal_the_reference():
    assert {k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in r_configs.SHAPES.items()}
    for a in configs.ARCHS:
        assert configs.shapes_for(configs.get_config(a)) == \
            r_configs.shapes_for(r_configs.get_config(a))
    assert configs.all_cells() == r_configs.all_cells()
    assert len(configs.all_cells()) == 32


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_dry_run_inputs_equal_the_reference(arch):
    """input_specs for every applicable shape, frontend_spec and the AdamW
    state at full width: meta tensors of the reference's shapes and
    dtypes, nothing allocated."""
    cfg, rcfg = configs.get_config(arch), r_configs.get_config(arch)
    model, rmodel = Model(cfg), RModel(rcfg)
    for name in configs.shapes_for(cfg):
        sh = configs.SHAPES[name]
        got = model.input_specs(name, sh.seq_len, sh.global_batch, sh.mode)
        want = rmodel.input_specs(name, sh.seq_len, sh.global_batch, sh.mode)
        assert all(t.device.type == "meta" for t in C.tree_leaves(got)
                   if isinstance(t, torch.Tensor) and t.dim())
        _same_specs(got, want)
        _same_specs({"f": frontends.frontend_spec(cfg, sh.global_batch, sh.seq_len)},
                    {"f": r_frontends.frontend_spec(rcfg, sh.global_batch, sh.seq_len)})
    got = adamw.abstract_state(model.param_specs(), adamw.AdamWConfig(moment_dtype=cfg.opt_dtype))
    want = r_adamw.abstract_state(rmodel.param_specs(),
                                  r_adamw.AdamWConfig(moment_dtype=rcfg.opt_dtype))
    _same_specs(got, want)
    _same_specs(model.abstract(), rmodel.abstract())


def _param_shard_shapes(arch, multi_pod, fsdp_pod):
    mesh, rmesh = _meshes(multi_pod)
    rules = _rules(multi_pod, fsdp_pod)
    specs = Model(configs.get_config(arch)).param_specs()
    rspecs = RModel(r_configs.get_config(arch)).param_specs()
    got = {k: C.shard_shape(s.shape, mesh, p) for (k, s), p in zip(
        _flat(specs, C.is_spec_leaf).items(),
        _flat(C.param_shardings(specs, mesh, rules), _is_placements).values())}
    rsh = _flat(RC.param_shardings(rspecs, rmesh, rules),
                lambda x: isinstance(x, jax.sharding.NamedSharding))
    want = {k: rsh[k].shard_shape(s.shape) for k, s in _flat(rspecs, RC.is_spec_leaf).items()}
    return got, want


@pytest.mark.parametrize("multi_pod,fsdp_pod", RULE_SETS)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_shard_shapes_equal_the_reference(arch, multi_pod, fsdp_pod):
    got, want = _param_shard_shapes(arch, multi_pod, fsdp_pod)
    assert got == want


def _input_shard_shapes(arch, name, multi_pod):
    """{path: shard shape} of the step's batch (or token and cache) in both
    packages, from the shardings' own functions."""
    mesh, rmesh = _meshes(multi_pod)
    cfg, rcfg = configs.get_config(arch), r_configs.get_config(arch)
    sh = configs.SHAPES[name]
    specs = Model(cfg).input_specs(name, sh.seq_len, sh.global_batch, sh.mode)
    rspecs = RModel(rcfg).input_specs(name, sh.seq_len, sh.global_batch, sh.mode)
    if sh.mode == "decode":
        pl = {"token": steps.batch_shardings(mesh, {"t": specs["token"]})["t"],
              "cache": steps.cache_shardings(mesh, specs["cache"], cfg)}
        rpl = {"token": r_steps.batch_shardings(rmesh, {"t": rspecs["token"]})["t"],
               "cache": r_steps.cache_shardings(rmesh, rspecs["cache"], rcfg)}
    else:
        pl, rpl = steps.batch_shardings(mesh, specs), r_steps.batch_shardings(rmesh, rspecs)
    got = {k: None if s is None else C.shard_shape(tuple(s.shape), mesh, p) for (k, s), p in
           zip(_flat(specs).items(), _flat(pl, lambda x: x is None or _is_placements(x)).values())}
    rpl = _flat(rpl, lambda x: x is None or isinstance(x, jax.sharding.NamedSharding))
    want = {k: None if s is None else rpl[k].shard_shape(tuple(s.shape))
            for k, s in _flat(rspecs, _is_sds).items()}
    return got, want, specs


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_batch_and_cache_shard_shapes_equal_the_reference(arch, multi_pod):
    for name in configs.shapes_for(configs.get_config(arch)):
        got, want, _ = _input_shard_shapes(arch, name, multi_pod)
        assert got == want, name


# ---------------------------------------------------------------------------
# lower_cell on the fake production meshes
# ---------------------------------------------------------------------------


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _argument_bytes_oracle(arch: str, name: str, multi_pod: bool) -> int:
    """The cell's argument bytes from the reference's shard shapes of the
    smoke config (parameters, AdamW moments and step counter in training;
    the batch, or the token and the decode cache)."""
    cfg, rcfg = configs.get_smoke_config(arch), r_configs.get_smoke_config(arch)
    mesh, rmesh = _meshes(multi_pod)
    rules = _rules(multi_pod, False)
    sh = configs.SHAPES[name]
    rspecs = RModel(rcfg).param_specs()
    rsh = _flat(RC.param_shardings(rspecs, rmesh, rules),
                lambda x: isinstance(x, jax.sharding.NamedSharding))
    leaves = _flat(rspecs, RC.is_spec_leaf)
    total = sum(_nbytes(rsh[k].shard_shape(s.shape), getattr(torch, _dtype_name(s.dtype)))
                for k, s in leaves.items())
    if sh.mode == "train":
        moment = _nbytes((1,), cfg.opt_dtype)
        total += 2 * sum(math.prod(rsh[k].shard_shape(s.shape)) * moment
                         for k, s in leaves.items()) + 4
    rmodel = RModel(rcfg)
    rspecs = rmodel.input_specs(name, sh.seq_len, sh.global_batch, sh.mode)
    if sh.mode == "decode":
        rpl = {"token": r_steps.batch_shardings(rmesh, {"t": rspecs["token"]})["t"],
               "cache": r_steps.cache_shardings(rmesh, rspecs["cache"], rcfg)}
    else:
        rpl = r_steps.batch_shardings(rmesh, rspecs)
    rpl = _flat(rpl, lambda x: x is None or isinstance(x, jax.sharding.NamedSharding))
    for k, s in _flat(rspecs, _is_sds).items():
        if s is not None:
            total += _nbytes(rpl[k].shard_shape(tuple(s.shape)),
                             getattr(torch, _dtype_name(s.dtype)))
    return total


# each cell with the regions it must list as run outside DTensor
CELLS = [("qwen3_4b", "train_4k", False, {"flash_mha.backward"}),
         ("qwen3_4b", "prefill_32k", True, set()),
         ("qwen2_moe_a2_7b", "prefill_32k", False, {"moe.dispatch", "moe.combine"}),
         ("seamless_m4t_large_v2", "decode_32k", True, {"attention.decode_chunked"}),
         ("falcon_mamba_7b", "long_500k", True, set()),
         ("falcon_mamba_7b", "prefill_32k", False, {"ssm.causal_conv", "ssm.linear_scan"}),
         ("recurrentgemma_2b", "decode_32k", False, {"attention.decode_chunked"})]


@pytest.mark.parametrize("arch,name,multi_pod,regions", CELLS)
def test_lower_cell_argument_bytes_equal_the_shard_bytes(arch, name, multi_pod, regions):
    res, coll = D.lower_cell(arch, name, multi_pod=multi_pod,
                             cfg_override=configs.get_smoke_config(arch))
    assert res["mesh"] == ("pod2x16x16" if multi_pod else "16x16")
    assert res["memory"]["argument_size_in_bytes"] == _argument_bytes_oracle(arch, name, multi_pod)
    assert res["flops"] > 0 and res["bytes_accessed"] > 0
    assert res["memory"]["temp_size_in_bytes"] > 0 and res["memory"]["output_size_in_bytes"] > 0
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    assert res["params"] == RModel(r_configs.get_smoke_config(arch)).param_count()
    assert regions <= res["local_regions"].keys()


def test_op_records_add_up_and_the_loss_keeps_the_vocab_sharded():
    """``lower_cell``'s op records add up to the cell's FLOPs and collective
    bytes, and their live bytes peak at its temp bytes.  The train step's
    cross entropy builds no (batch, seq, whole vocab) tensor: the label
    mask and its gradient's ``where`` keep the vocab sharded (a pointwise
    rule that follows the labels' placements would build both whole)."""
    cfg = configs.get_smoke_config("qwen3_4b")
    ops: list[dict] = []
    res, coll = D.lower_cell("qwen3_4b", "train_4k", cfg_override=cfg, ops=ops)
    assert sum(o["flops"] for o in ops) == res["flops"]
    assert max(o["live"] for o in ops) == res["memory"]["temp_size_in_bytes"]
    by_kind: dict[str, float] = {}
    for o in ops:
        for k, v in o["collectives"].items():
            by_kind[k] = by_kind.get(k, 0.0) + v
    assert by_kind == {k: v for k, v in coll.items() if k != "total"}
    # tensors the ops allocate (a broadcast view of the row's gradient
    # has the whole vocab's shape and no storage of its own)
    whole_vocab = [(o["op"], sh) for o in ops if o["allocated"] > 0 for sh in o["shapes"]
                   if len(sh) == 3 and sh[1] > 1 and sh[2] == cfg.vocab_size]
    assert not whole_vocab, whole_vocab[:3]
    assert any(len(sh) == 3 and sh[2] == cfg.vocab_size // 16
               for o in ops if o["op"] == "eq" for sh in o["shapes"])


def _plain_fake_flops(model: Model, shape: configs.ShapeSpec) -> int:
    """FlopCounterMode's count of ``shape``'s step on plain fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    cfg = model.cfg
    with FakeTensorMode():
        def real(t):
            return torch.empty(t.shape, dtype=t.dtype) if isinstance(t, torch.Tensor) else t
        params = C.tree_map(real, model.abstract())
        batch = C.tree_map(real, model.input_specs(shape.name, shape.seq_len,
                                                   shape.global_batch, shape.mode))
        opt_cfg = adamw.AdamWConfig(moment_dtype=cfg.opt_dtype)
        if shape.mode == "train":
            fn = steps.make_train_step(model, opt_cfg)
            state = C.tree_map(real, adamw.abstract_state(model.param_specs(), opt_cfg))
            args = (params, state, batch)
        else:
            fn, args = steps.make_prefill_step(model), (params, batch)
        with FlopCounterMode(display=False) as counter:
            with torch.enable_grad() if shape.mode == "train" else torch.no_grad():
                fn(*args)
    return counter.get_total_flops()


@pytest.mark.parametrize("arch,mode", [("qwen3_4b", "train"), ("qwen3_4b", "prefill"),
                                       ("qwen2_moe_a2_7b", "train")])
def test_one_rank_dry_run_counts_what_flop_counter_counts(arch, mode):
    """On a one-rank mesh every op runs whole, so the dry run's per-device
    FLOPs (B7 by its formula included) equal FlopCounterMode's on the same
    step without DTensor."""
    cfg = configs.get_smoke_config(arch)
    shape = configs.ShapeSpec("card", 32, 2, mode)
    mesh = D.fake_mesh((1, 1), ("data", "model"))
    res = D.lower_shape(cfg, shape, mesh, launch_mesh.LOGICAL_RULES_SINGLE)
    assert res["flops"] == _plain_fake_flops(Model(cfg), shape)
    assert res["collectives"] == {"total": 0.0}


def test_global_batch_for_mesh_is_the_ranks_rows():
    """The reference's one-host batch, split on its leading dim over the
    mesh's batch axes: this rank's rows as the local shard of a DTensor of
    the global shape."""
    from torch.distributed.tensor import Replicate, Shard

    from repro.data.pipeline import DataConfig as RDataConfig
    from repro.data.pipeline import host_batch as r_host_batch
    from repro_torch.data.pipeline import DataConfig, global_batch_for_mesh

    mesh = D.fake_mesh((2, 4, 4), ("pod", "data", "model"))
    kw = dict(vocab_size=1000, seq_len=16, global_batch=32, seed=3)
    got = global_batch_for_mesh(DataConfig(**kw), 5, mesh, ("pod", "data"))
    want = r_host_batch(RDataConfig(**kw), 5)
    for k in ("tokens", "labels"):
        assert tuple(got[k].shape) == (32, 16)
        assert tuple(got[k].placements) == (Shard(0), Shard(0), Replicate())
        assert np.array_equal(got[k].to_local().numpy(), np.asarray(want[k])[:4])
