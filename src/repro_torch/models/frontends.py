"""Modality frontend stubs, PyTorch port of :mod:`repro.models.frontends`.

``[audio]`` / ``[vlm]`` architectures specify the transformer backbone
only; the frontend supplies precomputed frame / patch embeddings.  These
helpers give the stub's token count and a deterministic synthetic
embedding drawn as the reference draws it (``jax.random.normal`` through
:mod:`repro_torch.sim._jaxrandom`, bit for bit); ``frontend_spec`` is the
dry run's stand-in for them (a meta tensor, no allocation).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import common as C
from repro_torch.sim import _jaxrandom


def frontend_tokens(cfg: C.ModelConfig, seq_len: int | None = None) -> int:
    """Number of prefix embeddings the frontend contributes."""
    if cfg.frontend == "vision":
        return cfg.vision_tokens
    if cfg.frontend == "audio":
        # encoder input: audio frames downsampled 4x from a nominal window
        return (seq_len or 1024) // cfg.audio_downsample
    return 0


def frontend_spec(cfg: C.ModelConfig, batch: int,
                  seq_len: int | None = None) -> torch.Tensor | None:
    """A meta tensor of the precomputed embeddings' shape and dtype (the
    dry run's input; the reference's ``ShapeDtypeStruct``)."""
    n = frontend_tokens(cfg, seq_len)
    if n == 0:
        return None
    return torch.empty((batch, n, cfg.d_model), dtype=torch.bfloat16, device="meta")


def synth_embeddings(cfg: C.ModelConfig, batch: int, key, seq_len: int | None = None,
                     device=None) -> torch.Tensor | None:
    """(batch, n, d_model) bfloat16 frontend embeddings on ``device`` (the
    card unless ``"cpu"``): ``jax.random.normal(key, ...) * 0.02`` rounded
    to bfloat16, for ``key`` a :func:`repro_torch.sim._jaxrandom.key` (the
    reference's ``jax.random.key``)."""
    dev = resolve_device(device)
    n = frontend_tokens(cfg, seq_len)
    if n == 0:
        return None
    x = _jaxrandom.normal(key, (batch, n, cfg.d_model)) * np.float32(0.02)
    return torch.from_numpy(x).to(dev).to(torch.bfloat16)
