"""Multi-pod dry run: trace every (arch x shape x mesh) cell, PyTorch port of
:mod:`repro.launch.dryrun`.

This shows the distribution config coherent without the hardware, under
the two DTensor rules the dry run changes for its own duration
(:func:`_dry_run_rules`): a view that would split a sharded dim unevenly
replicates that mesh dim first, and a Shard -> Shard move is one
all-to-all.  A cell that ends OK here is therefore not shown runnable on
a real DTensor mesh, whose view rule would raise at those views.  Its
shardings follow DTensor's op-by-op choices, which differ between torch
versions (in the backward, a partial sum reduced at once or carried
further), so a cell's collective and temp bytes are those of the
installed torch.

Each cell's train, prefill or decode step (:mod:`repro_torch.launch.steps`)
runs once on the single-pod (16, 16) mesh AND the 2-pod (2, 16, 16) =
512-rank mesh, for every assigned architecture and its applicable input
shapes, with:

- a fake process group of 256 or 512 ranks
  (``torch.testing._internal.distributed.fake_pg``: collectives return at
  once) under a ``DeviceMesh`` from :func:`repro_torch.launch.mesh.
  make_production_mesh`;
- parameters, AdamW moments, batch and decode cache as DTensors with the
  step's placements (``Model.shardings``, ``steps.batch_shardings``,
  ``steps.cache_shardings``) over fake local shards (``FakeTensorMode``:
  nothing is allocated), and the model's ``constrain`` calls live
  (``sharding_ctx``);
- B7 counted as B7: its operator's fake implementation, FLOP formula and
  DTensor sharding rule (:mod:`repro_torch.kernels.flash_attention.ops`).

One rank's local ops are counted as they run (:class:`DeviceCost`):
FLOPs by ``torch.utils.flop_counter``'s formulas on the local shapes,
bytes accessed as the bytes of every compute op's tensor inputs and
outputs, collectives' result bytes by kind, and the peak of live bytes
the step allocates.  Failures (a sharding mismatch, an op with no DTensor
rule) are bugs.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out out.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k \
        --layers 2 --ops-out ops.json    # one cell cut to 2 layers, op by op

The fake process group is global to the process: the CLI runs in a
process of its own, and a process that also runs the card paths must call
:func:`lower_cell` in a subprocess.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, get_config, shapes_for
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import common as C
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.roofline.analysis import CollectiveBytes, _with_total

# ops that move no data besides views (their output aliases an input) and
# the ``empty*`` allocations, which write nothing
_NO_TRAFFIC = {"detach", "alias", "lift_fresh", "wait_tensor"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in C.tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _Propagating:
    """Marks DTensor's sharding propagation, which runs each op once more
    on global-shape fake tensors to learn its output's metadata; those
    runs are not a rank's work and are not counted."""

    depth = 0


# DTensor's method that runs an op on global-shape fake tensors, by torch
# version (the first one the installed torch has is wrapped)
_META_PROPAGATION = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")


@contextlib.contextmanager
def _mark_propagation():
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = next((n for n in _META_PROPAGATION if hasattr(ShardingPropagator, n)), None)
    if name is None:
        raise RuntimeError(f"torch {torch.__version__}: DTensor's ShardingPropagator has none "
                           f"of {_META_PROPAGATION}; the dry run cannot tell its metadata "
                           f"runs from a rank's ops")
    orig = getattr(ShardingPropagator, name)

    @functools.wraps(orig)
    def marked(*args, **kwargs):
        _Propagating.depth += 1
        try:
            return orig(*args, **kwargs)
        finally:
            _Propagating.depth -= 1

    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's Shard(i) -> Shard(j) step as on a GPU mesh: one all-to-all
    (on a CPU mesh DTensor gathers the whole tensor instead, which would
    count the mesh dim's size times the bytes)."""
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)


def _clear_sharding_cache(prop) -> None:
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if native is not None:      # the C++ dispatch fast path's own cache
        native()
    for owner in (prop, type(prop)):
        for name in ("propagate_op_sharding", "_propagate_tensor_meta_cached"):
            clear = getattr(getattr(owner, name, None), "cache_clear", None)
            if clear is not None:
                clear()


def _dim_size(spec, shape) -> int:
    """The size of one output dim of a view rule (DTensor's ``DimSpec``s:
    ``InputDim``, ``Flatten``, ``Split``, ``Singleton``, ``Broadcast``,
    ``NewDim``, ``Repeat``), read by their fields."""
    kind = type(spec).__name__
    if kind == "InputDim":
        return shape[spec.input_dim]
    if kind == "Flatten":
        return math.prod(_dim_size(d, shape) for d in spec.input_dims)
    if kind == "Split":
        return spec.group_shape[spec.split_id]
    if kind == "Singleton":
        return 1
    if kind == "Broadcast":
        return spec.dim_size
    if kind == "NewDim":
        return spec.size
    if kind == "Repeat":
        return _dim_size(spec.input_dim, shape) * spec.times
    raise TypeError(f"view rule entry {spec!r}")


def _uneven_mesh_dim(rule, shape, mesh_sizes, placements) -> int | None:
    """The first mesh dim of ``placements`` (a view's output) that shards an
    output dim its mesh dims do not divide, or in strides (DTensor's
    ``_StridedShard``, which some of its rules cannot take), or None."""
    sizes = [_dim_size(spec, shape) for spec in rule]
    split: dict[int, int] = {}
    for m, p in enumerate(placements):
        if p.is_shard():
            split[p.dim] = split.get(p.dim, 1) * mesh_sizes[m]
            if sizes[p.dim] % split[p.dim] or type(p).__name__ == "_StridedShard":
                return m
    return None


def _replicating_views(orig):
    """DTensor's view rule made to redistribute where it would refuse or
    mis-split: the rule is asked in its lenient form (which replicates a
    dim it cannot split itself), and where its output still shards a dim
    its mesh dims do not divide (a dim sharded on three mesh dims slips
    past its check) or shards one in strides, or where it raises naming a
    mesh dim, the input is replicated on that mesh dim before it is asked
    again.  The redistribution is an all-gather, counted."""
    import re

    def propagate(input_src_placements, global_input_shape, rule, mesh_sizes, *_):
        from torch.distributed.tensor import Replicate

        placements = list(input_src_placements)
        for _ in range(len(placements) + 1):
            try:
                tgt, out = orig(placements, global_input_shape, rule, mesh_sizes, False)
                m = _uneven_mesh_dim(rule, global_input_shape, mesh_sizes, out)
                if m is None:
                    return tgt, out
            except RuntimeError as e:
                found = re.search(r"unevenly sharded.*mesh dimension (\d+)", str(e))
                if found is None:
                    raise
                m = int(found.group(1))
            if not placements[m].is_shard():
                raise RuntimeError(f"view of a {tuple(global_input_shape)} tensor under "
                                   f"{tuple(input_src_placements)}: mesh dim {m} is not "
                                   f"sharded, nothing to replicate")
            placements[m] = Replicate()
        raise RuntimeError(f"view of a {tuple(global_input_shape)} tensor: no placements "
                           f"left to replicate")

    return propagate


@contextlib.contextmanager
def _dry_run_rules():
    """Two of DTensor's rules changed for the dry run, put back after, its
    sharding caches emptied at both ends.  (1) The view rule raises where a
    view would split a sharded dim unevenly (``einsum`` views its product's
    output, (B*S, Hkv*D) sharded over 16 ranks, as (B, S, 8, D)), or, in its
    lenient form, mis-splits a dim sharded on several mesh dims; here the
    input is replicated on those mesh dims first (:func:`_replicating_views`),
    as XLA's partitioner would reshard, and the collective is counted.  (2)
    Shard -> Shard moves are one all-to-all, as on the card's mesh
    (:func:`_shard_dim_alltoall`), where the installed torch has the op.
    Each cell starts from empty caches: DTensor keys some ops' decisions
    without their scalar arguments (``topk``'s k), so one arch's cached
    decision could serve another's."""
    import sys

    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._ops import _view_ops

    prop = DTensor._op_dispatcher.sharding_propagator
    views = _view_ops.propagate_shape_and_sharding
    _view_ops.propagate_shape_and_sharding = _replicating_views(views)
    _clear_sharding_cache(prop)
    patched = []
    if hasattr(torch.ops._dtensor, "shard_dim_alltoall"):
        for mod in ("placement_types", "_redistribute", "_collective_utils"):
            m = sys.modules.get(f"torch.distributed.tensor.{mod}")
            if m is not None and callable(getattr(m, "shard_dim_alltoall", None)):
                patched.append((m, m.shard_dim_alltoall))
                m.shard_dim_alltoall = _shard_dim_alltoall
    try:
        yield
    finally:
        for m, fn in patched:
            m.shard_dim_alltoall = fn
        _view_ops.propagate_shape_and_sharding = views
        _clear_sharding_cache(prop)


class DeviceCost(CollectiveBytes):
    """One rank's cost of what runs inside it: ``flops`` (the registered
    formulas on local shapes; B7's own), ``bytes_accessed`` (the bytes of
    every compute op's tensor inputs and outputs on the local shards),
    collectives' result bytes (``by_kind``), and ``peak_bytes``, the most
    bytes held at once by storages allocated inside (weak references to
    each storage: a storage counts from the op that made it until Python
    frees it).  Given a list ``ops``, appends one record an op counted:
    its name, output shapes, live bytes after it and its change, its FLOPs
    and its collective bytes by kind (to tell where two cells, or two
    torch versions, part)."""

    def __init__(self, ops: list | None = None):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.live = self.peak_bytes = 0
        self._refs: dict[int, weakref.ref] = {}
        self._seen: set[int] = set()
        self.ops = ops

    def exclude(self, tensors) -> None:
        """Storages that exist before the step (its arguments): written in
        place, never counted as allocations."""
        for t in tensors:
            self._seen.add(id(t.untyped_storage()))

    def _freed(self, key: int, nbytes: int, _ref) -> None:
        if self._refs.pop(key, None) is not None:
            self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs or key in self._seen:
            return
        nbytes = st.nbytes()
        self._refs[key] = weakref.ref(st, functools.partial(self._freed, key, nbytes))
        self.live += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._is_dtensor_op(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _Propagating.depth:
            return out
        before = None if self.ops is None else (self.live, self.flops, dict(self.by_kind))
        self._count_collective(func, out)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        outs = _tensors(out)
        if not (func.is_view or func._opname in _NO_TRAFFIC
                or func._opname.startswith("empty")):
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes_accessed += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        if before is not None:
            live, flops, by_kind = before
            self.ops.append({
                "op": func._opname, "shapes": [list(t.shape) for t in outs],
                "live": self.live, "allocated": self.live - live, "flops": self.flops - flops,
                "collectives": {k: v - by_kind.get(k, 0.0) for k, v in self.by_kind.items()
                                if v != by_kind.get(k, 0.0)}})
        return out


# ---------------------------------------------------------------------------
# Fake process group, sharded fake arguments
# ---------------------------------------------------------------------------


def _ensure_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0 (an
    existing fake group of another size is replaced; a real one raises)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(f"the dry run needs a fake process group; this process "
                               f"runs a {dist.get_backend()!r} group")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def fake_mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over a fake group of its size (e.g. a
    one-rank ``(1, 1)`` mesh for a card's own cell)."""
    from torch.distributed.device_mesh import init_device_mesh

    _ensure_fake_group(math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def production_mesh(multi_pod: bool):
    """The production mesh over a fake group of its size."""
    shape, _ = mesh_lib.production_shape(multi_pod)
    _ensure_fake_group(math.prod(shape))
    return mesh_lib.make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def _sharded(meta, placements, mesh):
    """The DTensor tree of a meta-tensor tree under a placements tree: fake
    local shards (created under the caller's ``FakeTensorMode``); a
    non-tensor leaf (the cache's host ``len``) as it is."""
    from torch.distributed.tensor import DTensor

    if isinstance(meta, dict):
        return {k: _sharded(v, placements[k], mesh) for k, v in meta.items()}
    if isinstance(meta, (list, tuple)):
        return type(meta)(_sharded(m, p, mesh) for m, p in zip(meta, placements))
    if not isinstance(meta, torch.Tensor):
        return meta
    local = torch.empty(C.shard_shape(tuple(meta.shape), mesh, placements), dtype=meta.dtype)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=meta.shape, stride=meta.stride())


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    return sum(_nbytes(t._local_tensor if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


def _locals(tree) -> list[torch.Tensor]:
    from torch.distributed.tensor import DTensor

    return [t._local_tensor if isinstance(t, DTensor) else t for t in _tensors(tree)]


def _run_step(model: Model, shape: ShapeSpec, mesh, rules: dict,
              ops: list | None = None) -> dict:
    """Run ``shape``'s step of ``model`` once on DTensors over ``mesh``
    (fake local shards, counted by :class:`DeviceCost`, its op records
    appended to ``ops`` if given).  Returns the per-device counts and
    memory."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = model.cfg
    flash_ops.register_sharding_rule()
    param_specs = model.param_specs()
    param_pl = C.param_shardings(param_specs, mesh, rules)
    fake = FakeTensorMode()
    with fake:
        params = _sharded(model.abstract(), param_pl, mesh)
        if shape.mode == "train":
            opt_cfg = adamw.AdamWConfig(moment_dtype=cfg.opt_dtype)
            replicated = C.spec_placements((), mesh)
            opt_pl = {"mu": param_pl, "nu": param_pl, "step": replicated}
            opt_state = _sharded(adamw.abstract_state(param_specs, opt_cfg), opt_pl, mesh)
            batch_specs = model.input_specs(shape.name, shape.seq_len, shape.global_batch, "train")
            batch = _sharded(batch_specs, steps.batch_shardings(mesh, batch_specs), mesh)
            fn, args = steps.make_train_step(model, opt_cfg), (params, opt_state, batch)
        elif shape.mode == "prefill":
            batch_specs = model.input_specs(shape.name, shape.seq_len, shape.global_batch,
                                            "prefill")
            batch = _sharded(batch_specs, steps.batch_shardings(mesh, batch_specs), mesh)
            fn, args = steps.make_prefill_step(model), (params, batch)
        elif shape.mode == "decode":
            specs = model.input_specs(shape.name, shape.seq_len, shape.global_batch, "decode")
            tok = _sharded(specs["token"],
                           steps.batch_shardings(mesh, {"t": specs["token"]})["t"], mesh)
            cache_specs = dict(specs["cache"])
            # a full cache: the step appends at position seq_len - 1 (a host
            # int, as decode_step reads it)
            cache_specs["len"] = shape.seq_len - 1
            cache = _sharded(cache_specs, steps.cache_shardings(mesh, cache_specs, cfg), mesh)
            cache["len"] = torch.tensor(shape.seq_len - 1, dtype=torch.int32)
            fn, args = steps.make_decode_step(model), (params, tok, cache)
        else:
            raise ValueError(f"shape {shape.name}: unknown mode {shape.mode!r}")
    arg_bytes = _local_bytes(args)
    cost = DeviceCost(ops)
    cost.exclude(_locals(args))
    grad = torch.enable_grad() if shape.mode == "train" else torch.no_grad()
    with fake, _mark_propagation(), _dry_run_rules(), C.sharding_ctx(mesh, rules), \
            implicit_replication(), grad, cost:
        out = fn(*args)
        out_bytes = _local_bytes(out)
        regions = C.regions()
        del out
    return {"flops": float(cost.flops), "bytes_accessed": float(cost.bytes_accessed),
            "memory": {"argument_size_in_bytes": int(arg_bytes),
                       "output_size_in_bytes": int(out_bytes),
                       "temp_size_in_bytes": int(cost.peak_bytes)},
            "collectives": _with_total(cost.by_kind), "local_regions": regions}


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               rules_override=None, cfg_override=None, ops: list | None = None):
    """Trace one (arch, shape, mesh) cell on its production mesh.

    Returns ``(result, collectives)``: the reference's keys (``flops`` and
    ``bytes_accessed`` per device; ``memory``'s argument, output and temp
    bytes per device) plus ``collectives`` (result bytes by kind and
    ``"total"``, the roofline's collective input) and ``local_regions``
    (the calls of each region the step ran outside DTensor,
    :func:`repro_torch.models.common.local_region`).  ``cfg_override``
    substitutes a modified ModelConfig (the roofline analysis traces
    shallow variants).  ``ops``, a list, receives one record an op of
    the rank (:class:`DeviceCost`)."""
    cfg = cfg_override or get_config(arch)
    mesh = production_mesh(multi_pod)
    rules = dict(mesh_lib.rules_for(mesh))
    if rules_override:
        rules.update(rules_override)
    model = Model(cfg)
    t0 = time.time()
    res = _run_step(model, SHAPES[shape_name], mesh, rules, ops)
    out = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "pod2x16x16" if multi_pod else "16x16",
        "compile_s": round(time.time() - t0, 1),
        "flops": res["flops"],
        "bytes_accessed": res["bytes_accessed"],
        "memory": res["memory"],
        "params": model.param_count(),
        "collectives": res["collectives"],
        "local_regions": res["local_regions"],
    }
    return out, res["collectives"]


def lower_shape(cfg, shape: ShapeSpec, mesh, rules=None) -> dict:
    """The dry run of ``cfg`` at a shape of the caller's (a card's own
    cell: no entry in ``SHAPES``) on ``mesh`` (e.g. a one-rank mesh)."""
    return _run_step(Model(cfg), shape, mesh, dict(rules or {}))


def run_cells(cells, multi_pod: bool, out_path: str | None,
              hlo_dir: str | None = None):
    results, failures = [], []
    for arch, shape in cells:
        try:
            res, coll = lower_cell(arch, shape, multi_pod=multi_pod)
            print(f"OK   {arch:24s} {shape:12s} {res['mesh']:10s} "
                  f"trace={res['compile_s']}s flops={res['flops']:.3e} "
                  f"mem={res['memory'].get('temp_size_in_bytes', 0)/2**30:.2f}GiB", flush=True)
            if hlo_dir:
                os.makedirs(hlo_dir, exist_ok=True)
                tag = f"{arch}__{shape}__{res['mesh']}"
                with open(os.path.join(hlo_dir, tag + ".collectives.json"), "w") as f:
                    json.dump(coll, f, indent=1)
            results.append(res)
        except Exception as e:  # noqa: BLE001 — report and continue
            print(f"FAIL {arch:24s} {shape:12s}: {e}", flush=True)
            traceback.print_exc()
            failures.append({"arch": arch, "shape": shape, "error": str(e)})
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"results": results, "failures": failures}, f, indent=1)
    print(f"\n{len(results)} cells OK, {len(failures)} failed")
    return results, failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--hlo-dir", default=None,
                    help="dump each cell's collective bytes by kind (roofline input)")
    ap.add_argument("--layers", type=int, default=None,
                    help="with --arch/--shape: the config cut to this many layers")
    ap.add_argument("--ops-out", default=None,
                    help="with --arch/--shape: write the cell's result and one record "
                         "an op (live bytes, FLOPs, collective bytes) to this JSON")
    args = ap.parse_args(argv)

    if args.layers is not None or args.ops_out:
        if args.all or not (args.arch and args.shape):
            ap.error("--layers/--ops-out take one cell: --arch and --shape")
        arch = args.arch.replace("-", "_").replace(".", "_")
        cfg = get_config(arch)
        if args.layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=args.layers)
        ops: list[dict] = []
        res, _ = lower_cell(arch, args.shape, multi_pod=args.multi_pod, cfg_override=cfg,
                            ops=ops)
        print(json.dumps({k: res[k] for k in ("flops", "memory", "collectives")}))
        if args.ops_out:
            with open(args.ops_out, "w") as f:
                json.dump({"torch": torch.__version__, "result": res, "ops": ops}, f)
        return

    if args.all:
        cells = [(a, s) for a in ARCHS for s in shapes_for(get_config(a))]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch.replace("-", "_").replace(".", "_"), args.shape)]
    _, failures = run_cells(cells, args.multi_pod, args.out, args.hlo_dir)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
