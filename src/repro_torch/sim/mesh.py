"""Mesh-sharded lane dispatch, PyTorch port of :mod:`repro.sim.mesh`:
shard the stacked lane axis over devices.

Every batched engine folds its whole cross-product onto one stacked lane
axis (:mod:`repro_torch.sim.study`), and lanes are embarrassingly
parallel — no mechanism's window loop communicates across lanes.  This
module spreads that axis over a 1-D ``lanes`` mesh of devices, with the
reference's three invariants:

* **The single-device path is unchanged.**  ``devices=1`` runs the very
  same dispatch as before the mesh existed — no shard call, no split, no
  copy — so it stays the differential reference the sharded path is held
  to bit for bit (``tests/test_torch_mesh_dispatch.py``).
* **Mesh widths compose with the blessed widths.**  A sharded dispatch
  needs its lane count divisible by the mesh size, so buckets pad up to
  :func:`mesh_lane_width` with all-sentinel masked lanes
  (:func:`repro_torch.sim.prep.dummy_lane_triple`, zero contribution by
  the window-validity masking).  Mesh sizes are powers of two
  (:func:`devices_for`), so every blessed coalesce width >= the mesh size
  is already a mesh multiple (:mod:`repro_torch.serve.coalesce`).
* **Scarce-lane buckets route to device subsets.**  A bucket with fewer
  lanes than devices runs on the largest power-of-two subset its lanes
  fill (:func:`devices_for`).

The mesh of a CUDA run is ``cuda:0 … cuda:d−1``, one lane shard a card,
each launching its kernels on its own card.  The CPU has one device;
:data:`MESH_ENV_VAR` — the variable the reference's CPU CI sets to force
XLA host devices — gives the CPU mesh that many entries of ``cpu``, read
at call time, so one setting drives both packages' mesh tests.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch.device import resolve_device

LANE_AXIS = "lanes"
MESH_ENV_VAR = "XLA_FORCE_HOST_PLATFORM_DEVICE_COUNT"

__all__ = [
    "LANE_AXIS", "MESH_ENV_VAR", "force_host_device_count",
    "available_devices", "resolve_devices", "devices_for", "mesh_lane_width",
    "lane_mesh", "shard_lanes",
]


def force_host_device_count() -> int | None:
    """The CPU device count :data:`MESH_ENV_VAR` forces, or ``None`` when it
    is unset or empty; a value that is not an integer raises ``ValueError``,
    as the reference's ``int(n)`` does.

    The reference translates the variable into ``XLA_FLAGS`` at import,
    because XLA fixes its host device count when its backend starts.  The
    port sets no ``XLA_FLAGS``: torch has no such backend setting, and
    :func:`available_devices` reads the variable at each call, so nothing
    has to run before a device is touched."""
    n = os.environ.get(MESH_ENV_VAR)
    return int(n) if n else None


def available_devices(device=None) -> int:
    """The visible device count of ``device``'s type (``None``: the CUDA
    card): every visible CUDA device (:data:`MESH_ENV_VAR` ignored), or on
    the CPU the count :data:`MESH_ENV_VAR` forces, else 1."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.device_count()
    return force_host_device_count() or 1


def resolve_devices(devices: int | None = None, device=None) -> int:
    """Normalize a ``devices=`` argument: ``None`` means every visible
    device of ``device``'s type; explicit counts are checked against what is
    visible, so a manifest or config written on a bigger host fails loudly
    here, not inside a dispatch."""
    if devices is None:
        return available_devices(device)
    devices = int(devices)
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    avail = available_devices(device)
    if devices > avail:
        raise ValueError(
            f"devices={devices} but only {avail} visible (CPU CI forces more "
            f"via {MESH_ENV_VAR})")
    return devices


def devices_for(lanes: int, devices: int) -> int:
    """The mesh size a ``lanes``-wide dispatch actually runs on: the
    largest power of two <= min(lanes, devices)."""
    if lanes < 1:
        raise ValueError(f"devices_for needs lanes >= 1, got {lanes}")
    d = 1
    while d * 2 <= min(lanes, devices):
        d *= 2
    return d


def mesh_lane_width(lanes: int, devices: int) -> int:
    """The padded lane count of a sharded dispatch: the smallest multiple
    of ``devices`` >= ``lanes``."""
    if devices < 1:
        raise ValueError(f"mesh_lane_width needs devices >= 1, got {devices}")
    return -(-lanes // devices) * devices


def lane_mesh(devices: int, device=None) -> tuple[torch.device, ...]:
    """The 1-D lane mesh over the first ``devices`` devices of ``device``'s
    type: ``cuda:0 … cuda:d−1``, or ``devices`` entries of ``cpu`` (the
    counterpart of XLA's forced host devices)."""
    dev = resolve_device(device)
    devices = resolve_devices(devices, dev)
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i) for i in range(devices))
    return (torch.device("cpu"),) * devices


def _shard(x, lo: int, hi: int, dev: torch.device):
    """Lanes ``lo:hi`` of a record (a dataclass whose tensor fields carry
    the lane axis first) on ``dev``; other fields as they are."""
    return dataclasses.replace(x, **{
        f.name: getattr(x, f.name)[lo:hi].to(dev) for f in dataclasses.fields(x)
        if isinstance(getattr(x, f.name), torch.Tensor)})


def shard_lanes(fn, devices: int, device=None):
    """Wrap a lane-batched function so its leading lane axis shards over a
    ``devices``-wide lane mesh.  ``fn(*records)`` takes records (dataclasses)
    whose tensor fields all carry the stacked lane axis first and returns a
    dict of lane-leading tensors; the wrapper splits every record into
    ``devices`` equal shards, runs ``fn`` on shard i on mesh device i (each
    shard's work enqueued before any result is gathered), and gathers the
    outputs in lane order on ``device``.  No lane reads another, so there is
    nothing to communicate."""
    mesh = lane_mesh(devices, device)
    home = resolve_device(device)

    def sharded(*records):
        lanes = next(getattr(r, f.name) for r in records for f in dataclasses.fields(r)
                     if isinstance(getattr(r, f.name), torch.Tensor)).shape[0]
        if lanes % len(mesh):
            raise ValueError(f"{lanes} lanes do not shard over {len(mesh)} devices "
                             f"(pad to mesh_lane_width first)")
        n = lanes // len(mesh)
        outs = [fn(*(_shard(r, i * n, (i + 1) * n, dev) for r in records))
                for i, dev in enumerate(mesh)]
        return {k: torch.cat([o[k].to(home) for o in outs]) for k in outs[0]}

    return sharded
