"""Deterministic synthetic token pipeline with per-host sharding, PyTorch
port of :mod:`repro.data.pipeline`.

Each host materializes only its shard of the global batch (``host_batch =
global_batch / num_hosts``), derived from a counter-based PRNG keyed on
(seed, step, host): resuming at step k regenerates the identical batch,
with no iterator state to checkpoint beyond the step counter.  The stream
is a structured integer LM task (a periodic skeleton plus noise tokens)
that a model can reduce loss on.  The draws are the reference's
``jax.random`` ones, bit for bit (:mod:`repro_torch.sim._jaxrandom`), so
tokens and labels equal the reference's.  ``global_batch_for_mesh``
gives a rank its shard of the global batch as a DTensor on a
``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sim import _jaxrandom


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


def _fold(*ints: int):
    key = _jaxrandom.key(ints[0])
    for i in ints[1:]:
        key = _jaxrandom.fold_in(key, i)
    return key


def host_batch(cfg: DataConfig, step: int, device=None) -> dict[str, torch.Tensor]:
    """The (host_batch, seq+1) token block for ``step``, split into int32
    inputs and next-token labels, on ``device`` (the card unless
    ``"cpu"``)."""
    dev = resolve_device(device)
    k1, k2, k3 = _jaxrandom.split(_fold(cfg.seed, step, cfg.host_id), 3)
    b, s, v = cfg.host_batch, cfg.seq_len + 1, cfg.vocab_size
    # periodic skeleton + per-seq offset + noise tokens
    period = 3 + _jaxrandom.randint(k1, (b, 1), 0, 13)
    offset = _jaxrandom.randint(k2, (b, 1), 0, v)
    pos = np.arange(s, dtype=np.int32)[None, :]
    skeleton = (offset + (pos % period) * 17) % v
    noise = _jaxrandom.randint(k3, (b, s), 0, v)
    is_noise = _jaxrandom.bernoulli(_fold(cfg.seed, step, cfg.host_id, 7), 0.15, (b, s))
    toks = torch.from_numpy(np.where(is_noise, noise, skeleton).astype(np.int32)).to(dev)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def global_batch_for_mesh(cfg: DataConfig, step: int, mesh, batch_axes) -> dict:
    """The global batch of ``step`` sharded on its leading dim over the mesh
    axes ``batch_axes`` (a name or a tuple of names) of the ``DeviceMesh``
    ``mesh``: this rank's rows of the one-host batch, as DTensors on the
    mesh's device type (``DTensor.from_local``; every rank draws the same
    global batch, so no rank waits on another)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    axes = (batch_axes,) if isinstance(batch_axes, str) else tuple(batch_axes)
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    data = host_batch(dataclasses.replace(cfg, num_hosts=1, host_id=0), step, device="cpu")
    # rank's block index over the batch axes, the first axis major
    idx, n = 0, 1
    for a in axes:
        i = names.index(a)
        idx, n = idx * mesh.shape[i] + coord[i], n * mesh.shape[i]
    rows = cfg.global_batch // n
    placements = [Shard(0) if name in axes else Replicate() for name in names]
    dev = torch.device(mesh.device_type) if mesh.device_type == "cpu" else \
        resolve_device(mesh.device_type)
    return {k: DTensor.from_local(v[idx * rows:(idx + 1) * rows].to(dev), mesh, placements,
                                  run_check=False) for k, v in data.items()}
