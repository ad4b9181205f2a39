"""Step functions (train / prefill / decode) + sharding resolution,
PyTorch port of :mod:`repro.launch.steps`.  The port runs the steps
eagerly on the tensors' device where the reference jits them; on DTensors
over a mesh (the dry run, :mod:`repro_torch.launch.dryrun`) the same steps
run sharded, with ``batch_shardings`` / ``cache_shardings`` giving their
inputs' placements and the logical-rule ``sharding_ctx`` their internal
constraints.
"""

from __future__ import annotations

import itertools
from typing import Any

import torch

from repro_torch.models import common as C
from repro_torch.models.common import tree_leaves, tree_unflatten
from repro_torch.models.model import Model
from repro_torch.optim import adamw


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig):
    """``train_step(params, opt_state, batch) -> {"loss", "grad_norm",
    "lr"}``: the loss and its gradient with respect to every parameter leaf
    (zeros for a leaf the loss does not reach, as ``jax.value_and_grad``
    gives), then one AdamW update written into ``params`` and
    ``opt_state`` (:func:`adamw.step_`), where the reference's step
    returns new trees.  Each call runs in the span ``step.train``, whose
    argument is the call's number (0, 1, ...)."""
    calls = itertools.count()

    def train_step(params, opt_state, batch):
        with C.span("step.train", next(calls)):
            leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
            loss = model.loss(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = tree_unflatten(params, (torch.zeros_like(p) if g is None else g
                                            for p, g in zip(leaves, grads)))
            metrics = adamw.step_(params, grads, opt_state, opt_cfg)
            return {"loss": loss.detach(), **metrics}
    return train_step


def make_prefill_step(model: Model):
    """``prefill_step(params, batch) -> (B, V)`` last-position logits; each
    call runs in the span ``step.prefill``, whose argument is the call's
    number (0, 1, ...)."""
    calls = itertools.count()

    def prefill_step(params, batch: dict) -> torch.Tensor:
        with C.span("step.prefill", next(calls)):
            logits, _ = model.apply(
                params, batch["tokens"],
                prefix_embeds=batch.get("prefix_embeds"),
                frames=batch.get("frames"))
            # serving prefill returns only the last position's logits (a
            # copy, so the (B, S, V) logits are freed)
            return logits[:, -1, :].clone()
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, token, cache):
        return model.decode(params, token, cache)
    return decode_step


# ---------------------------------------------------------------------------
# Sharding resolution for non-parameter trees
# ---------------------------------------------------------------------------


def _batch_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _div(n: int, mesh, axes: tuple[str, ...]) -> bool:
    sizes = C.mesh_axes(mesh)
    size = 1
    for a in axes:
        size *= sizes[a]
    return n % size == 0 and n >= size


def batch_shardings(mesh, batch_specs: dict) -> dict:
    """Shard every batch input on its leading (global-batch) dim: DTensor
    placements, one per mesh dim (None for an absent input)."""
    ba = _batch_axes(mesh)

    def f(s):
        if s is None:
            return None
        spec: list[Any] = [None] * len(s.shape)
        if _div(s.shape[0], mesh, ba):
            spec[0] = ba
        return C.spec_placements(tuple(spec), mesh)

    return {k: f(v) for k, v in batch_specs.items()}


def cache_shardings(mesh, cache_specs: dict, cfg: C.ModelConfig) -> dict:
    """Decode-cache placements: batch over (pod,data) when divisible; heads /
    channels over model; for unshardable-head caches (MQA) the KV sequence
    dim shards over model instead."""
    ba = _batch_axes(mesh)
    m = C.mesh_axes(mesh)["model"]
    replicated = C.spec_placements((), mesh)

    def kv(s):
        # (L, B, S, H, D)
        spec: list[Any] = [None] * 5
        if _div(s.shape[1], mesh, ba):
            spec[1] = ba
        if s.shape[3] % m == 0:
            spec[3] = ("model",)
        elif s.shape[2] % m == 0:
            spec[2] = ("model",)
        return C.spec_placements(tuple(spec), mesh)

    def chan_last(s):
        spec: list[Any] = [None] * len(s.shape)
        if len(s.shape) >= 2 and _div(s.shape[1], mesh, ba):
            spec[1] = ba
        for i in (len(s.shape) - 1, len(s.shape) - 2):
            if i > 1 and s.shape[i] % m == 0 and s.shape[i] >= 128:
                spec[i] = ("model",)
                break
        return C.spec_placements(tuple(spec), mesh)

    out: dict = {}
    for key, sub in cache_specs.items():
        if key == "len":
            out[key] = replicated
        elif key == "kv":
            out[key] = {"k": kv(sub["k"]), "v": kv(sub["v"]), "pos": replicated}
        elif key in ("ssm", "rec"):
            out[key] = {k: chan_last(v) for k, v in sub.items()}
        else:
            out[key] = {k: replicated for k in sub}
    return out
