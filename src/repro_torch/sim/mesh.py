"""Lane-mesh helpers, single-device subset (PyTorch port of the parts of
:mod:`repro.sim.mesh` this slice needs).

Every batched engine folds its cross-product onto one stacked lane axis;
the reference can shard that axis over a 1-D device mesh.  The port runs
on one device: ``devices`` must be 1 (or ``None``, meaning one), and a
larger count raises a ``ValueError`` naming the slice that brings the
multi-GPU lane mesh.  :func:`devices_for` and
:func:`mesh_lane_width` are the reference's routing arithmetic, so
``Study.plan()`` reports the same per-bucket routing.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

MESH_SLICE = ("the multi-GPU lane mesh comes with the mesh slice of the port "
              "(ROADMAP queue A9); this slice runs on one device")


def available_devices(device=None) -> int:
    """The visible device count of ``device``'s type (``None``: the CUDA
    card): every visible CUDA device, or 1 for the CPU."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def resolve_devices(devices: int | None = None) -> int:
    """Normalize a ``devices=`` argument: ``None`` and 1 mean one device;
    anything above 1 is not ported yet."""
    if devices is None:
        return 1
    devices = int(devices)
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    if devices > 1:
        raise ValueError(f"devices={devices}: {MESH_SLICE}")
    return devices


def devices_for(lanes: int, devices: int) -> int:
    """The largest power of two <= min(lanes, devices): the mesh size a
    ``lanes``-wide dispatch runs on."""
    if lanes < 1:
        raise ValueError(f"devices_for needs lanes >= 1, got {lanes}")
    d = 1
    while d * 2 <= min(lanes, devices):
        d *= 2
    return d


def mesh_lane_width(lanes: int, devices: int) -> int:
    """The smallest multiple of ``devices`` >= ``lanes``."""
    if devices < 1:
        raise ValueError(f"mesh_lane_width needs devices >= 1, got {devices}")
    return -(-lanes // devices) * devices
