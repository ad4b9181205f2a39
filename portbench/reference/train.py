"""The reference's training steps and the per-tensor readings both sides
are compared on.

A *unit* is one parameter tensor as the model has it unstacked: the
embedding, the head, the final norm, and each layer's slice of each stacked
leaf.  :func:`units` gives views, so writing a unit writes the tree.

The optimizer is AdamW as the traffic file configures it: the global
gradient norm clipped to ``clip_norm``; float32 moments; bias-corrected
update; decoupled weight decay on matrices (a unit of two or more dims);
the cosine schedule with warm-up and a floor of a tenth of ``lr``.  The
parameters are stored in the configuration's parameter dtype (bfloat16):
each update is computed in float32 and rounded to it.
"""

from __future__ import annotations

import math

import torch

from portbench import weights as W
from portbench.reference.model import Reference

STACKED = ("stack", "period", 0)


def units(tree: dict) -> dict:
    """{name: tensor view} of every unit of a parameter tree."""
    out = {"embed": tree["embed"], "final_norm": tree["stack"]["final_norm"]}
    if "lm_head" in tree:
        out["lm_head"] = tree["lm_head"]
    block = tree["stack"]["period"][0]
    for group, leaves in block.items():
        for name, t in leaves.items():
            for i in range(t.shape[0]):
                out[f"layer{i}.{group}.{name}"] = t[i]
    return out


def grad_units(g: dict) -> dict:
    """:func:`units` of the reference's gradient structure."""
    out = {"embed": g["embed"], "final_norm": g["final_norm"], "lm_head": g["lm_head"]}
    for i, layer in enumerate(g["layers"]):
        for group, leaves in layer.items():
            for name, t in leaves.items():
                out[f"layer{i}.{group}.{name}"] = t
    return out


def learning_rate(step: int, opt: dict) -> float:
    """The schedule at ``step`` (1-based)."""
    warm = opt["warmup_steps"]
    w = min(step / max(warm, 1), 1.0)
    frac = min(max((step - warm) / max(opt["total_steps"] - warm, 1), 0.0), 1.0)
    return opt["lr"] * w * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * frac)))


def norms(tensors: dict) -> dict:
    """{name: float32 norm} of a dict of tensors, read in one transfer."""
    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].to(torch.float32))
                        for n in names]).tolist()
    return dict(zip(names, vals))


def train_steps(cfg: dict, opt: dict, params: dict, batches: list,
                precision: str = "float32") -> dict:
    """Train ``params`` (overwritten) on ``batches`` ((ids, labels) each).
    Returns each step's loss and pre-clip gradient norm, and the norms of
    each unit's gradient as the optimizer takes it (clipped) at the first
    step."""
    u = units(params)
    mu = {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device) for n, t in u.items()}
    nu = {n: torch.zeros_like(m) for n, m in mu.items()}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    losses, gnorms, first = [], [], {}
    for step, (ids, labels) in enumerate(batches, start=1):
        loss, g = Reference(cfg, params, precision).loss_and_grads(ids, labels)
        g = grad_units(g)
        gnorm = math.sqrt(sum(v ** 2 for v in norms(g).values()))
        scale = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0)
        if step == 1:
            first = {"units": {n: v * scale for n, v in norms(g).items()}}
        lr = learning_rate(step, opt)
        c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
        for n, p in u.items():
            gi = g.pop(n) * scale
            mu[n].mul_(b1).add_(gi, alpha=1.0 - b1)
            nu[n].mul_(b2).addcmul_(gi, gi, value=1.0 - b2)
            del gi
            delta = (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + eps)
            pf = p.to(torch.float32)
            if p.dim() >= 2:
                delta += opt["weight_decay"] * pf
            p.copy_(pf - lr * delta)
        losses.append(float(loss))
        gnorms.append(gnorm)
    return {"losses": losses, "grad_norms": gnorms, **first}


def change_norms(cfg: dict, seed: int, params: dict, device) -> dict:
    """{unit: norm of (params - the seed's initial weights)}, float32; the
    initial weights are drawn again a leaf at a time."""
    out = {}
    names = {("embed",): "embed", ("lm_head",): "lm_head", ("stack", "final_norm"): "final_norm"}
    for path, spec in W.leaf_paths(W.layout(cfg)):
        p0 = W.draw_leaf(cfg, seed, path, spec, device)
        now = _get(params, path)
        if path[:3] == STACKED:
            vals = torch.stack([torch.linalg.vector_norm(now[i].float() - p0[i].float())
                                for i in range(now.shape[0])]).tolist()
            out.update({f"layer{i}.{path[3]}.{path[4]}": x for i, x in enumerate(vals)})
        else:
            out[names[path]] = float(torch.linalg.vector_norm(now.float() - p0.float()))
        del p0
    return out


def _get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree
