"""Step functions (train / prefill / decode), PyTorch port of
:mod:`repro.launch.steps`.  The port runs them eagerly on the tensors'
device where the reference jits them; the sharding helpers
(``batch_shardings``, ``cache_shardings``) belong to the dry run and the
launch mesh and are not ported.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import tree_leaves, tree_unflatten
from repro_torch.models.model import Model
from repro_torch.optim import adamw


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig):
    """``train_step(params, opt_state, batch) -> {"loss", "grad_norm",
    "lr"}``: the loss and its gradient with respect to every parameter leaf
    (zeros for a leaf the loss does not reach, as ``jax.value_and_grad``
    gives), then one AdamW update written into ``params`` and
    ``opt_state`` (:func:`adamw.step_`), where the reference's step
    returns new trees."""
    def train_step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = model.loss(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_unflatten(params, (torch.zeros_like(p) if g is None else g
                                        for p, g in zip(leaves, grads)))
        metrics = adamw.step_(params, grads, opt_state, opt_cfg)
        return {"loss": loss.detach(), **metrics}
    return train_step


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
