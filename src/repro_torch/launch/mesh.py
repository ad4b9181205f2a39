"""Production mesh construction + logical-axis rules, PyTorch port of
:mod:`repro.launch.mesh`.

``make_production_mesh`` is a function (not a module-level constant) so
importing this module never touches a process group.  The single-pod mesh
is (data=16, model=16) = 256 ranks; multi-pod adds a leading pod axis for
2 x 256 = 512 ranks.  The ``pod`` axis composes with ``data`` for FSDP+DP
(batch and parameter sharding span both), so the same logical rules serve
both meshes.  The mesh is a ``torch.distributed`` ``DeviceMesh`` over the
process group the caller started (one rank a card; the dry run starts a
fake group of 256 or 512 ranks, :mod:`repro_torch.launch.dryrun`).  On an
H100 host a 16-wide ``model`` axis spans two 8-card NVLink domains.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.sim import mesh as sim_mesh

LANE_AXIS = sim_mesh.LANE_AXIS

__all__ = [
    "LANE_AXIS", "LOGICAL_RULES_SINGLE", "LOGICAL_RULES_MULTI",
    "LOGICAL_RULES_MULTI_FSDP_POD", "make_production_mesh", "make_lane_mesh",
    "rules_for", "production_shape",
]


def production_shape(multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The production mesh's (dim sizes, dim names)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) ``("pod",
    "data", "model")`` with ``multi_pod``, over the default process group,
    which must have exactly 256 (512) ranks; raises naming the world size
    otherwise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = production_shape(multi_pod)
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else None
    if world != need:
        have = "no process group" if world is None else f"a world size of {world}"
        raise RuntimeError(f"make_production_mesh(multi_pod={multi_pod}) needs a process "
                           f"group of {need} ranks; there is {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_lane_mesh(num_devices: int, device=None) -> tuple[torch.device, ...]:
    """A 1-D ``lanes`` mesh over the first ``num_devices`` devices of
    ``device``'s type (the card unless ``"cpu"``) — the simulator's
    lane-sharding axis (:func:`repro_torch.sim.mesh.lane_mesh`).  Lanes are
    embarrassingly parallel (no cross-lane collective in any mechanism
    scan), so the only logical rule a lane mesh needs is the leading
    stacked-lane dim -> ``lanes``."""
    if num_devices < 1:
        raise ValueError(f"make_lane_mesh needs num_devices >= 1, "
                         f"got {num_devices}")
    visible = sim_mesh.available_devices(device)
    if num_devices > visible:
        raise ValueError(
            f"make_lane_mesh: {num_devices} devices requested but only "
            f"{visible} visible (force more CPU devices with "
            f"XLA_FORCE_HOST_PLATFORM_DEVICE_COUNT)")
    return sim_mesh.lane_mesh(num_devices, device)


# Logical-axis -> mesh-axis rules.  Parameters FSDP-shard their embed dim
# over data (and pod); vocab/heads/mlp/experts shard over model (TP/EP);
# batch shards over (pod, data).
LOGICAL_RULES_SINGLE: dict[str, Any] = {
    "batch": ("data",),
    "embed": ("data",),
    "embed_table": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "rnn": ("model",),
    "kv_seq": ("model",),
    "seq_sp": ("model",),
}

LOGICAL_RULES_MULTI: dict[str, Any] = {
    **LOGICAL_RULES_SINGLE,
    "batch": ("pod", "data"),
    "embed": ("data",),        # FSDP within a pod; pod axis replicates params
}

# Fully-sharded variant for the largest configs: parameters also shard the
# embed dim over the pod axis (FSDP across pods).
LOGICAL_RULES_MULTI_FSDP_POD: dict[str, Any] = {
    **LOGICAL_RULES_MULTI,
    "embed": ("pod", "data"),
}


def rules_for(mesh, *, fsdp_pod: bool = False) -> dict[str, Any]:
    """Logical-axis rules for a production mesh (a ``DeviceMesh``, or
    anything with its ``mesh_dim_names``).  ``fsdp_pod=True`` selects the
    fully-sharded variant (parameters FSDP over the pod axis too) and
    requires a multi-pod mesh — on a single-pod mesh there is no pod axis
    to shard over, so asking for it is a config error, not a silent
    fallback."""
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        if fsdp_pod:
            raise ValueError(
                f"rules_for(fsdp_pod=True) needs a multi-pod mesh (a 'pod' "
                f"axis); this mesh has axes {names}")
        return LOGICAL_RULES_SINGLE
    return LOGICAL_RULES_MULTI_FSDP_POD if fsdp_pod else LOGICAL_RULES_MULTI
