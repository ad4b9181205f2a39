"""The port's launch mesh and logical-axis rules held against repro:
``tests/test_mesh_dispatch.py::test_rules_for_fsdp_pod_flag`` on the port,
the three production rule sets and ``DEFAULT_RULES`` equal to the
reference's, ``_resolve_axes`` equal to the reference's partition specs,
the production mesh's refusal without a process group of its size, the
lane mesh's argument checks, and ``constrain`` / ``gather_fsdp`` /
``local_region`` returning their input unchanged outside a sharding
context (the card paths pay nothing for them)."""

from __future__ import annotations

import types

import jax
import pytest
import torch

from repro.launch import mesh as r_mesh
from repro.models import common as RC
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import common as C


def test_rules_for_fsdp_pod_flag():
    single = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    multi = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert launch_mesh.rules_for(single) is launch_mesh.LOGICAL_RULES_SINGLE
    assert launch_mesh.rules_for(multi) is launch_mesh.LOGICAL_RULES_MULTI
    assert launch_mesh.rules_for(multi, fsdp_pod=True) \
        is launch_mesh.LOGICAL_RULES_MULTI_FSDP_POD
    assert launch_mesh.LOGICAL_RULES_MULTI_FSDP_POD["embed"] == \
        ("pod", "data")
    with pytest.raises(ValueError, match="multi-pod"):
        launch_mesh.rules_for(single, fsdp_pod=True)


@pytest.mark.parametrize("name", ["LOGICAL_RULES_SINGLE", "LOGICAL_RULES_MULTI",
                                  "LOGICAL_RULES_MULTI_FSDP_POD"])
def test_rule_sets_equal_the_reference(name):
    assert getattr(launch_mesh, name) == getattr(r_mesh, name)


def test_default_rules_equal_the_reference():
    assert C.DEFAULT_RULES == RC.DEFAULT_RULES
    assert launch_mesh.LANE_AXIS == r_mesh.LANE_AXIS


def test_production_shapes_equal_the_reference():
    for multi_pod in (False, True):
        shape, names = launch_mesh.production_shape(multi_pod)
        want = jax.sharding.AbstractMesh(shape, names)
        assert dict(want.shape) == C.mesh_axes(C.AbstractMesh(shape, names))


_AXES = [("embed", "mlp"), ("vocab", "embed_table"), ("expert", "embed", "mlp"),
         ("batch", "seq", "heads", None), ("layers", "embed", "kv_heads", None),
         ("rnn", "state"), ("batch", "kv_seq", "kv_heads", None), (None,),
         ("embed", "embed")]
_SHAPES = [(2560, 9728), (151936, 2560), (64, 2048, 1408), (256, 4096, 32, 128),
           (36, 2560, 8, 128), (8192, 16), (128, 32768, 1, 256), (7,), (4096, 32)]


@pytest.mark.parametrize("rules", ["LOGICAL_RULES_SINGLE", "LOGICAL_RULES_MULTI",
                                   "LOGICAL_RULES_MULTI_FSDP_POD"])
def test_resolve_axes_equals_the_reference(rules):
    """Logical axes -> partition spec, dim by dim as the reference resolves
    it (divisibility, each mesh axis used once), with and without a shape,
    and the placements' shard shape against ``NamedSharding.shard_shape``."""
    multi = rules != "LOGICAL_RULES_SINGLE"
    shape, names = launch_mesh.production_shape(multi)
    r_abstract = jax.sharding.AbstractMesh(shape, names)
    mesh = C.AbstractMesh(shape, names)
    full = {**C.DEFAULT_RULES, **getattr(launch_mesh, rules)}
    for axes, dims in zip(_AXES, _SHAPES):
        for sh in (dims, None):
            want = RC._resolve_axes(axes, full, r_abstract, sh)
            got = C._resolve_axes(axes, full, mesh, sh)
            # PartitionSpec keeps a one-axis entry as the axis name
            assert tuple(e[0] if e and len(e) == 1 else e for e in got) == tuple(want), \
                (axes, sh)
        spec = RC._resolve_axes(axes, full, r_abstract, dims)
        placements = C.spec_placements(C._resolve_axes(axes, full, mesh, dims), mesh)
        assert C.shard_shape(dims, mesh, placements) == \
            jax.sharding.NamedSharding(r_abstract, spec).shard_shape(dims)


def test_make_production_mesh_needs_a_group_of_its_size():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        pytest.fail("a process group is running in this process")
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"{n} ranks; there is no process group"):
            launch_mesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def test_make_lane_mesh_checks_its_argument(monkeypatch):
    with pytest.raises(ValueError, match="num_devices >= 1"):
        launch_mesh.make_lane_mesh(0, device="cpu")
    monkeypatch.setenv("XLA_FORCE_HOST_PLATFORM_DEVICE_COUNT", "2")
    with pytest.raises(ValueError, match="3 devices requested but only 2 visible"):
        launch_mesh.make_lane_mesh(3, device="cpu")
    assert launch_mesh.make_lane_mesh(2, device="cpu") == (torch.device("cpu"),) * 2


def test_sharding_helpers_are_identities_outside_a_context():
    x = torch.randn(2, 3, 4)
    tree = {"a": x, "b": [x]}
    assert C.active_mesh() is None
    assert C.constrain(x, "batch", "seq", "embed") is x
    assert C.gather_fsdp(tree) is tree
    assert C.logical_to_spec(("batch",), (2,)) == ()
    assert C.local_region("r", torch.neg, x).equal(-x)
    assert C.regions() == {}
