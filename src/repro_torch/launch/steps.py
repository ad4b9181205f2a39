"""Step functions (prefill / decode), PyTorch port of the serving part of
:mod:`repro.launch.steps`.  The port runs them eagerly on the tensors'
device; ``make_train_step`` and the sharding helpers (``batch_shardings``,
``cache_shardings``) come with the training and the dry-run / launch-mesh
slices (ROADMAP A11).
"""

from __future__ import annotations

import torch

from repro_torch.models.model import Model


def make_prefill_step(model: Model):
    def prefill_step(params, batch: dict) -> torch.Tensor:
        logits, _ = model.apply(
            params, batch["tokens"],
            prefix_embeds=batch.get("prefix_embeds"),
            frames=batch.get("frames"))
        # serving prefill returns only the last position's logits (a copy,
        # so the (B, S, V) logits are freed)
        return logits[:, -1, :].clone()
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, token, cache):
        return model.decode(params, token, cache)
    return decode_step
