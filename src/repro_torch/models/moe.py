"""Mixture-of-Experts block, PyTorch port of :mod:`repro.models.moe`:
shared experts + routed top-k with capacity.

1. router logits (float32) -> top-k (expert, weight) pairs per token
   (:func:`_routing`: padded experts masked, softmax, top-k, renormalised);
2. each pair's rank within its expert: ``dispatch="sort"`` (the default)
   sorts the flattened pairs by expert (stable) and subtracts each
   segment's start; ``"cumsum"`` counts the earlier tokens of the same
   expert with a cumulative one-hot sum (:func:`cumsum_rank`).  A token
   never picks one expert twice, so the two give every pair the same rank;
3. kept pairs (rank < capacity, ``max(8, int(cf * T * K / E))``; the rest
   drop, as in Switch / GShard) copy their token into an (E, C, d) buffer,
   the experts run as batched products, and each token sums its K weighted
   outputs.

``"ep"`` is the reference's expert-parallel ``shard_map`` formulation; it
needs a mesh, and without one the reference falls through to the local
formulation, as the port always does (under the dry run's mesh too, where
DTensor shards the local formulation by the ``constrain`` placements).

Everything is static-shape: no host synchronization and no
data-dependent size.  The combine is a gather and a sum in a fixed order,
never an atomic scatter-add, so a run on the card gives the same bits each
time: ``"sort"`` sums a token's contributions in ascending expert id (the
order of the reference's scatter-add over the sorted pairs), ``"cumsum"``
in top-k order (the reference's sum over K).  The dtype sites are the
reference's: the sort dispatch weights its gathered outputs in the
parameter dtype and combines in float32 when ``moe_combine_f32``; the
cumsum dispatch weights and combines in float32; the shared experts are
added as float32.

Aux losses: load balancing (Switch) and the router z-loss, returned for
the training objective.

While a profile records, :func:`moe_block` opens the spans (``common.span``)
``moe.route`` (the norm, router, top-k and aux losses), ``moe.dispatch``,
``moe.experts`` (the three products and the SwiGLU) and ``moe.combine``,
and counts (``common.count``) ``moe.pairs_routed`` (T * K),
``moe.rows_computed`` (E * C, the rows the expert products compute) and
``moe.pairs_kept`` (on the device); pairs dropped are routed minus kept.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as C


def moe_param_specs(cfg: C.ModelConfig) -> dict:
    moe = cfg.moe
    d = cfg.d_model
    e = moe.num_routed_padded
    de = moe.d_expert
    dt = cfg.param_dtype
    specs = {
        "norm": C.ParamSpec((d,), (None,), torch.float32, "zeros"),
        "router": C.ParamSpec((d, e), ("embed", "expert"), torch.float32,
                              "small_normal", 0.02 / (d ** 0.5)),
        # routed experts: SwiGLU, stacked on a leading expert dim
        "we_in": C.ParamSpec((e, d, de), ("expert", "embed", "mlp"), dt),
        "we_gate": C.ParamSpec((e, d, de), ("expert", "embed", "mlp"), dt),
        "we_out": C.ParamSpec((e, de, d), ("expert", "mlp", "embed"), dt),
    }
    if moe.num_shared > 0:
        ds = moe.num_shared * de
        specs.update({
            "ws_in": C.ParamSpec((d, ds), ("embed", "mlp"), dt),
            "ws_gate": C.ParamSpec((d, ds), ("embed", "mlp"), dt),
            "ws_out": C.ParamSpec((ds, d), ("mlp", "embed"), dt),
        })
    return specs


def capacity(moe: C.MoEConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens (Switch / GShard)."""
    return max(8, int(moe.capacity_factor * tokens * moe.top_k / moe.num_routed_padded))


def _routing(logits: torch.Tensor, num_experts: int, top_k: int, num_real: int):
    """Top-k routing with padding-expert masking. logits: (T, E) ->
    (gates (T, E), top_w (T, K), top_e (T, K) int64), the K picks in
    descending gate order."""
    if num_real < num_experts:
        pad = torch.arange(num_experts, device=logits.device) >= num_real
        logits = torch.where(pad, torch.finfo(logits.dtype).min, logits)
    x = logits.to(torch.float32)
    # exp(x - max) / sum, as jax.nn.softmax divides (torch.softmax may
    # multiply by the reciprocal)
    u = torch.exp(x - x.amax(dim=-1, keepdim=True))
    gates = u / u.sum(dim=-1, keepdim=True)
    top_w, top_e = torch.topk(gates, top_k, dim=-1, sorted=True)
    top_w = top_w / torch.clamp(top_w.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, top_w, top_e


def cumsum_rank(top_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Each (token, k) pair's rank within its expert: the number of earlier
    tokens routed to the same expert (the cumsum dispatch). (T, K) -> (T, K)."""
    onehot = F.one_hot(top_e, num_experts).sum(1)       # (T, E)
    pos = torch.cumsum(onehot, dim=0) - onehot
    return torch.gather(pos, 1, top_e)


def dispatch_plan(top_e: torch.Tensor, num_experts: int, dispatch: str):
    """Every (token, k) pair of ``top_e`` in the dispatch's own order, as
    flat (T*K,) tensors ``(tok, exp, rank, pair)``: its token, its expert,
    its rank within the expert and its index into ``top_e.reshape(-1)``;
    and (T, K) ``by_token``, the positions of each token's K pairs in the
    order its contributions are summed.  ``"cumsum"`` keeps token-major
    order; ``"sort"`` (and ``"ep"``) sorts by expert, stable."""
    t, k = top_e.shape
    dev = top_e.device
    pairs = torch.arange(t * k, device=dev)
    flat_e = top_e.reshape(-1)
    if dispatch == "cumsum":
        rank = cumsum_rank(top_e, num_experts).reshape(-1)
        return pairs // k, flat_e, rank, pairs, pairs.reshape(t, k)
    order = torch.argsort(flat_e, stable=True)
    exp = flat_e[order]
    seg_start = torch.searchsorted(exp, torch.arange(num_experts, device=dev), right=False)
    rank = pairs - seg_start[exp]
    # a token's pairs in sorted position order, i.e. ascending expert id
    inv = torch.empty_like(order).index_copy_(0, order, pairs)
    by_token = torch.sort(inv.reshape(t, k), dim=1).values
    return order // k, exp, rank, order, by_token


def route(p, x: torch.Tensor, cfg: C.ModelConfig):
    """The block's routing of x (B, S, d): (flat, logits, gates, top_w,
    top_e) — the normed tokens (T, d), the float32 router logits (T, E)
    and :func:`_routing`'s outputs."""
    moe = cfg.moe
    flat = C.rms_norm(x, p["norm"]).reshape(-1, x.shape[-1])
    logits = flat.to(torch.float32) @ p["router"]
    return (flat, logits) + _routing(logits, moe.num_routed_padded, moe.top_k,
                                     moe.num_experts)


def _dispatch(flat: torch.Tensor, top_e: torch.Tensor, e: int, cap: int, dispatch: str):
    """The kept pairs' tokens in an (E, C, d) buffer, and the plan the
    combine reads: (buf, keep, slot, pair, by_token)."""
    tok, exp, rank, pair, by_token = dispatch_plan(top_e, e, dispatch)
    keep = rank < cap
    slot = exp * cap + torch.where(keep, rank, 0)
    # kept pairs copy their token into the (E*C, d) buffer; dropped ones
    # land on a spare row that is cut off (kept slots are unique)
    d = flat.shape[-1]
    buf = torch.zeros((e * cap + 1, d), dtype=flat.dtype, device=flat.device)
    buf.index_copy_(0, torch.where(keep, slot, e * cap), flat[tok])
    return buf[:-1].reshape(e, cap, d), keep, slot, pair, by_token


def _combine(out_e: torch.Tensor, top_w: torch.Tensor, keep: torch.Tensor,
             slot: torch.Tensor, pair: torch.Tensor, by_token: torch.Tensor,
             cdt: torch.dtype | None) -> torch.Tensor:
    """Each token's K weighted expert outputs summed in the dispatch's
    order: (T, d).  ``cdt`` None is the cumsum dispatch (weights and sum
    in float32), else the sort dispatch's combine dtype (weights in the
    outputs' dtype)."""
    w = torch.where(keep, top_w.reshape(-1)[pair], 0.0)
    gathered = out_e.reshape(-1, out_e.shape[-1])[slot]            # (T*K, d)
    if cdt is None:
        contrib = gathered.to(torch.float32) * w[:, None]
    else:
        contrib = (gathered * w.to(out_e.dtype)[:, None]).to(cdt)
    per_token = contrib[by_token]                                  # (T, K, d)
    combined = per_token[:, 0]
    for kk in range(1, by_token.shape[1]):
        combined = combined + per_token[:, kk]
    return combined


def moe_block(p, x: torch.Tensor, cfg: C.ModelConfig):
    """x: (B, S, d) -> (out, aux) with aux = {load_balance, router_z}.
    Under a sharding context the dispatch and the combine (a sort and
    gathers over the whole token set) run replicated on each rank
    (``common.local_region``); the experts' products shard by the
    ``constrain`` on their buffer."""
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = moe.num_routed_padded
    cap = capacity(moe, t)

    with C.span("moe.route"):
        flat, logits, gates, top_w, top_e = route(p, x, cfg)

        # --- aux losses (Switch §2.2 + z-loss) ----------------------------
        me = torch.mean(gates, dim=0)                              # (E,)
        ce = torch.mean(F.one_hot(top_e[:, 0], e).to(torch.float32), dim=0)
        load_balance = e * torch.sum(me * ce)
        router_z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    with C.span("moe.dispatch"):
        buf, keep, slot, pair, by_token = C.local_region(
            "moe.dispatch", _dispatch, flat, top_e, e, cap, cfg.moe_dispatch, replicate=True)
    C.count("moe.pairs_routed", t * moe.top_k)
    C.count("moe.rows_computed", e * cap)
    C.count("moe.pairs_kept", keep)
    buf = C.constrain(buf, "expert", None, "embed")

    with C.span("moe.experts"):
        gate = torch.bmm(buf, p["we_gate"])
        up = torch.bmm(buf, p["we_in"])
        act = C.activation("swiglu", up, gate)
        out_e = torch.bmm(act, p["we_out"])

    cdt = None if cfg.moe_dispatch == "cumsum" else \
        (torch.float32 if cfg.moe_combine_f32 else x.dtype)
    with C.span("moe.combine"):
        combined = C.local_region("moe.combine", _combine, out_e, top_w, keep, slot, pair,
                                  by_token, cdt, replicate=True)
    if cfg.moe_dispatch != "cumsum":
        combined = C.constrain(combined.reshape(b, s, d), "batch", "seq",
                               "embed").reshape(t, d)

    # --- shared experts (always-on dense SwiGLU) ----------------------------
    if moe.num_shared > 0:
        sg = flat @ p["ws_gate"]
        su = flat @ p["ws_in"]
        shared = C.activation("swiglu", su, sg) @ p["ws_out"]
        combined = combined + shared.to(torch.float32)

    out = C.constrain(combined.reshape(b, s, d).to(x.dtype), "batch", "seq", "embed")
    return out, {"load_balance": load_balance, "router_z": router_z}
