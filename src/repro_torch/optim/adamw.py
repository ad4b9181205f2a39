"""AdamW with dtype-policied moments, global-norm clipping and cosine LR,
PyTorch port of :mod:`repro.optim.adamw`.

Moments live in ``cfg.moment_dtype`` (float32 by default; bfloat16 for the
340B config, halving optimizer memory).  ``init`` / ``step`` over trees of
tensors (nested dicts and lists), each leaf updated in float32 and cast
back to its dtype, in the reference's arithmetic; decoupled weight decay on
matrices only (ndim >= 2).  Where the reference's ``step`` returns new
parameters and state, the port's :func:`step_` writes them into the
tensors it is given (the parameters, both moments and the step counter)
and returns only the metrics, as a jitted step with donated buffers
would: a full-width step would otherwise hold the old and the new moments
at once (2 x 32 GB for qwen3-4b).  Clone a tree whose values must outlive
the step.  The step counter, the learning rate and the gradient norm are
0-dim tensors on the parameters' device, so a step never waits on the
device.  ``abstract_state`` gives the dry run's meta tensors.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.common import span, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: torch.dtype = torch.float32


def init(params, cfg: AdamWConfig) -> dict:
    def zero(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return {"mu": tree_map(zero, params), "nu": tree_map(zero, params), "step": step}


def abstract_state(param_specs_tree, cfg: AdamWConfig) -> dict:
    """Meta-tensor optimizer state for the dry run (no allocation)."""
    from repro_torch.models.common import is_spec_leaf

    def zero(s):
        return torch.empty(s.shape, dtype=cfg.moment_dtype, device="meta")
    return {"mu": tree_map(zero, param_specs_tree, is_spec_leaf),
            "nu": tree_map(zero, param_specs_tree, is_spec_leaf),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def step_(params, grads, state: dict, cfg: AdamWConfig) -> dict:
    """One AdamW update in place: ``params``, ``state["mu"]``,
    ``state["nu"]`` and ``state["step"]`` are overwritten.  Returns the
    metrics ``{"grad_norm", "lr"}``.  The whole update runs in the span
    ``adamw.step``."""
    with span("adamw.step"):
        count = state["step"].add_(1)
        gnorm = global_norm(grads)
        scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
        lr = _schedule(count, cfg)
        countf = count.to(torch.float32)
        bc1 = 1 - cfg.b1 ** countf
        bc2 = 1 - cfg.b2 ** countf
        for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(state["mu"]), tree_leaves(state["nu"]), strict=True):
            g = g.to(torch.float32) * scale
            mu_n = cfg.b1 * mu.to(torch.float32) + (1 - cfg.b1) * g
            nu_n = cfg.b2 * nu.to(torch.float32) + (1 - cfg.b2) * g * g
            del g
            delta = (mu_n / bc1) / (torch.sqrt(nu_n / bc2) + cfg.eps)
            mu.copy_(mu_n)
            nu.copy_(nu_n)
            del mu_n, nu_n
            # decoupled weight decay on matrices only (ndim >= 2)
            if p.dim() >= 2:
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr * delta)
        return {"grad_norm": gnorm, "lr": lr}
