"""Model stack assembly, PyTorch port of :mod:`repro.models.transformer`:
blocks -> layer loop -> logits, the encoder-decoder stack and the chunked
cross entropy.

A block = mixer (+ optional FFN), each with its own pre-norm and residual:

    kind 'attn'  : GQA attention            + dense MLP
    kind 'swa'   : sliding-window attention + dense MLP
    kind 'moe'   : GQA attention            + MoE FFN (shared + routed)
    kind 'mamba' : Mamba selective SSM mixer (no separate FFN)
    kind 'rglru' : Griffin RG-LRU recurrent  + dense MLP

Layer iteration: the block pattern's smallest repeating unit (the *period*)
is stacked on a leading axis, as in the reference; where the reference runs
``jax.lax.scan`` over that axis, the port loops over it in Python (each
stacked leaf unbound once, so a backward pass stacks its layers' gradients
in one step), and the non-divisible tail is unrolled.  ``cfg.remat`` wraps
each superblock, and each encoder block, in ``torch.utils.checkpoint``
(non-reentrant) when autograd records, under the reference's two policies:
``"nothing"`` recomputes every activation in the backward; ``"dots"``
saves the products that have no batch dimension (:func:`_dots_policy`)
and recomputes the rest.  Decode unrolls all layers and carries heterogeneous caches
(KV / conv+ssm / conv+h per kind), each indexed by its kind's own layer
counter; on an encoder-decoder config it runs the decoder stack with no
cross-attention, as the reference's does.  The stack returns the MoE aux
losses averaged over the MoE layers (zeros for a dense stack), as the
reference does.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                   create_selective_checkpoint_contexts)

from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R
from repro_torch.models import ssm as S

KINDS = ("attn", "swa", "moe", "mamba", "rglru")
ATTN_KINDS = ("attn", "swa", "moe")


_aten = torch.ops.aten
_DOTS = (_aten.mm.default, _aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: save
    the products with no batch dimension, recompute everything else.  The
    port's projections are ``torch.einsum("bsd,df->bsf", ...)``, which
    reaches the dispatcher as ``aten.bmm`` with a batch of one, so a
    ``bmm`` whose leading size is 1 counts as unbatched; attention's
    products (batch B*H), the experts' (batch E), B7 and every elementwise
    op are recomputed."""
    if op in _DOTS or (op == _aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: C.ModelConfig):
    """``fn`` under ``torch.utils.checkpoint`` when ``cfg.remat`` asks and
    autograd records, else ``fn`` itself.  ``remat_policy="dots"`` keeps
    :func:`_dots_policy`'s products; any other string saves nothing, as in
    the reference."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    if cfg.remat_policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy))
    return functools.partial(checkpoint, fn, use_reentrant=False)


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------


def mlp_param_specs(cfg: C.ModelConfig) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    specs = {
        "norm": C.ParamSpec((d,), (None,), torch.float32, "zeros"),
        "w_in": C.ParamSpec((d, f), ("embed", "mlp"), dt),
        "w_out": C.ParamSpec((f, d), ("mlp", "embed"), dt),
    }
    if cfg.mlp_act == "swiglu":
        specs["w_gate"] = C.ParamSpec((d, f), ("embed", "mlp"), dt)
    return specs


def mlp_block(p, x: torch.Tensor, cfg: C.ModelConfig) -> torch.Tensor:
    h = C.rms_norm(x, p["norm"])
    up = torch.einsum("bsd,df->bsf", h, p["w_in"])
    up = C.constrain(up, "batch", "seq", "mlp")
    gate = torch.einsum("bsd,df->bsf", h, p["w_gate"]) if cfg.mlp_act == "swiglu" else None
    act = C.activation(cfg.mlp_act, up, gate)
    out = torch.einsum("bsf,fd->bsd", act, p["w_out"])
    return C.constrain(out, "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def block_param_specs(kind: str, cfg: C.ModelConfig) -> dict:
    if kind in ("attn", "swa"):
        return {"mixer": A.attn_param_specs(cfg), "mlp": mlp_param_specs(cfg)}
    if kind == "moe":
        return {"mixer": A.attn_param_specs(cfg), "moe": M.moe_param_specs(cfg)}
    if kind == "mamba":
        return {"mixer": S.ssm_param_specs(cfg)}
    if kind == "rglru":
        return {"mixer": R.rglru_param_specs(cfg), "mlp": mlp_param_specs(cfg)}
    raise ValueError(f"block kind {kind!r}: not one of {KINDS}")


def apply_block(kind: str, p, x: torch.Tensor, cfg: C.ModelConfig,
                positions=None) -> tuple[torch.Tensor, dict]:
    aux = {}
    if kind in ("attn", "swa"):
        window = cfg.window_size if kind == "swa" else 0
        x = x + A.attn_block(p["mixer"], x, cfg, window=window, positions=positions)
        x = x + mlp_block(p["mlp"], x, cfg)
    elif kind == "moe":
        x = x + A.attn_block(p["mixer"], x, cfg, positions=positions)
        out, aux = M.moe_block(p["moe"], x, cfg)
        x = x + out
    elif kind == "mamba":
        x = x + S.ssm_block(p["mixer"], x, cfg)
    elif kind == "rglru":
        x = x + R.rglru_block(p["mixer"], x, cfg)
        x = x + mlp_block(p["mlp"], x, cfg)
    else:
        raise ValueError(kind)
    return x, aux


# ---------------------------------------------------------------------------
# Pattern / period machinery
# ---------------------------------------------------------------------------


def _period(cfg: C.ModelConfig) -> tuple[str, ...]:
    if cfg.block_pattern is not None:
        return cfg.block_pattern
    return (cfg.block_kind,)


def _split_layers(cfg: C.ModelConfig) -> tuple[int, tuple[str, ...]]:
    """(number of full stacked periods, unrolled tail kinds)."""
    per = _period(cfg)
    n_full = cfg.num_layers // len(per)
    tail = cfg.pattern[n_full * len(per):]
    return n_full, tail


def _stack_specs(specs: dict, n: int) -> dict:
    """Add a leading (n,) 'layers' axis to every ParamSpec leaf."""
    def f(s: C.ParamSpec) -> C.ParamSpec:
        return C.ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.dtype,
                           s.init, s.scale)
    return C.tree_map(f, specs, C.is_spec_leaf)


def stack_param_specs(cfg: C.ModelConfig) -> dict:
    """Parameter tree of the decoder stack (no embeddings)."""
    per = _period(cfg)
    n_full, tail = _split_layers(cfg)
    return {
        "period": [_stack_specs(block_param_specs(kind, cfg), n_full) for kind in per],
        "tail": [block_param_specs(kind, cfg) for kind in tail],
        "final_norm": C.ParamSpec((cfg.d_model,), (None,), torch.float32, "zeros"),
    }


def _index(tree, i: int):
    """Layer ``i`` of a tree stacked on its leading axis (views, no copy)."""
    return C.tree_map(lambda a: a[i], tree)


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a tree stacked on its leading axis, each leaf
    unbound once (views; one backward node a leaf for all its layers)."""
    cols = [a.unbind(0) for a in C.tree_leaves(tree)]
    return [C.tree_unflatten(tree, (col[i] for col in cols)) for i in range(n)]


def apply_stack(params, x: torch.Tensor, cfg: C.ModelConfig,
                positions=None) -> tuple[torch.Tensor, dict]:
    """Run the full block stack. Returns (hidden, aux_losses)."""
    per = _period(cfg)
    n_full, tail = _split_layers(cfg)

    def superblock(x, layer_params):
        aux_sum = torch.zeros((2,), dtype=torch.float32, device=x.device)
        for kind, p in zip(per, C.gather_fsdp(layer_params)):
            x, aux = apply_block(kind, p, x, cfg, positions=positions)
            if aux:
                aux_sum = aux_sum + torch.stack([aux["load_balance"], aux["router_z"]])
        return x, aux_sum

    body = _remat(superblock, cfg)
    aux_sum = torch.zeros((2,), dtype=torch.float32, device=x.device)
    for layer_params in _unstack(params["period"], n_full):
        x, aux = body(x, layer_params)
        aux_sum = aux_sum + aux
    for kind, p in zip(tail, params["tail"]):
        x, aux = apply_block(kind, C.gather_fsdp(p), x, cfg, positions=positions)
        if aux:
            aux_sum = aux_sum + torch.stack([aux["load_balance"], aux["router_z"]])
    x = C.rms_norm(x, params["final_norm"])
    n_moe = max(sum(1 for k in cfg.pattern if k == "moe"), 1)
    return x, {"load_balance": aux_sum[0] / n_moe, "router_z": aux_sum[1] / n_moe}


# ---------------------------------------------------------------------------
# LM: embeddings + stack + logits
# ---------------------------------------------------------------------------


def lm_param_specs(cfg: C.ModelConfig) -> dict:
    specs: dict[str, Any] = {
        "embed": C.ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed_table"),
                             cfg.param_dtype, "small_normal"),
        "stack": stack_param_specs(cfg),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = C.ParamSpec((cfg.d_model, cfg.vocab),
                                       ("embed", "vocab"), cfg.param_dtype)
    if cfg.encoder_layers > 0:
        specs["encoder"] = {
            "blocks": _stack_specs({"mixer": A.attn_param_specs(cfg),
                                    "mlp": mlp_param_specs(cfg)}, cfg.encoder_layers),
            "final_norm": C.ParamSpec((cfg.d_model,), (None,), torch.float32, "zeros"),
        }
        # per-decoder-layer cross attention (stacked like the period)
        n_full, tail = _split_layers(cfg)
        specs["cross"] = {
            "period": _stack_specs(A.attn_param_specs(cfg, cross=True), n_full),
            "tail": [A.attn_param_specs(cfg, cross=True) for _ in tail],
        }
    return specs


def embed_tokens(params, tokens: torch.Tensor, cfg: C.ModelConfig) -> torch.Tensor:
    # sqrt(d_model) rounded to the parameter dtype first, as the reference
    # does (50.5 in bfloat16 for d_model 2,560, not 50.596)
    scale = torch.full((), cfg.d_model ** 0.5, dtype=cfg.param_dtype,
                       device=params["embed"].device)
    # under a sharding context the lookup takes the table whole (DTensor's
    # vocab-sharded lookup leaves a masked partial sum that not every torch
    # the port runs on can differentiate); F.embedding is the same row
    # gather as indexing
    x = F.embedding(tokens, C.constrain(params["embed"], None, None)) * scale
    return C.constrain(x, "batch", "seq", "embed")


def logits_from_hidden(params, x: torch.Tensor, cfg: C.ModelConfig) -> torch.Tensor:
    """The LM head at every position of x, inside the span ``model.head``."""
    with C.span("model.head"):
        if cfg.tie_embeddings:
            logits = torch.einsum("bsd,vd->bsv", x, C.gather_fsdp(params["embed"]))
        else:
            logits = torch.einsum("bsd,dv->bsv", x, C.gather_fsdp(params["lm_head"]))
    return C.constrain(logits, "batch", "seq", "vocab")


def forward_hidden(params, tokens: torch.Tensor, cfg: C.ModelConfig,
                   prefix_embeds: torch.Tensor | None = None):
    """Decoder-only forward up to the final hidden states (pre-logits)."""
    x = embed_tokens(params, tokens, cfg)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    x, aux = apply_stack(params["stack"], x, cfg)
    if prefix_embeds is not None:
        x = x[:, prefix_embeds.shape[1]:, :]
    return x, aux


def forward(params, tokens: torch.Tensor, cfg: C.ModelConfig,
            prefix_embeds: torch.Tensor | None = None):
    """Decoder-only forward. tokens: (B, S) -> (logits, aux).

    ``prefix_embeds`` (B, P, d): modality-frontend outputs prepended to the
    token embeddings.
    """
    x, aux = forward_hidden(params, tokens, cfg, prefix_embeds)
    return logits_from_hidden(params, x, cfg), aux


def chunked_xent(params, hidden: torch.Tensor, labels: torch.Tensor,
                 cfg: C.ModelConfig) -> torch.Tensor:
    """Next-token xent over sequence chunks of ``cfg.loss_chunk``: never
    materializes the full (B, S, V) logits; each chunk is recomputed in the
    backward (``torch.utils.checkpoint``).  Padded vocabulary rows are
    masked out."""
    b, s, _ = hidden.shape
    ck = cfg.loss_chunk
    n = -(-s // ck)
    pad = n * ck - s
    h = F.pad(hidden, (0, 0, 0, pad))
    lab = F.pad(labels, (0, pad))
    msk = F.pad(torch.ones((b, s), dtype=torch.float32, device=hidden.device), (0, pad))

    def chunk_loss(hx, lx, mx):
        logits = logits_from_hidden(params, hx, cfg).to(torch.float32)
        if cfg.vocab_size < logits.shape[-1]:
            pad_mask = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab_size
            logits = torch.where(pad_mask, torch.finfo(torch.float32).min, logits)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, lx[..., None].to(torch.int64), dim=-1)[..., 0]
        return torch.sum((logz - gold) * mx)

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, n * ck, ck):
        tot = tot + checkpoint(chunk_loss, h[:, i:i + ck], lab[:, i:i + ck],
                               msk[:, i:i + ck], use_reentrant=False)
    return tot / (b * s)


# ---------------------------------------------------------------------------
# Encoder-decoder (seamless)
# ---------------------------------------------------------------------------


def encode(params, frames: torch.Tensor, cfg: C.ModelConfig) -> torch.Tensor:
    """Bidirectional encoder over precomputed frame embeddings (B, Se, d)."""
    enc = params["encoder"]

    def block(x, p):
        p = C.gather_fsdp(p)
        x = x + A.attn_block(p["mixer"], x, cfg, causal=False)
        return x + mlp_block(p["mlp"], x, cfg)

    body = _remat(block, cfg)
    x = frames.to(cfg.param_dtype)
    for p in _unstack(enc["blocks"], cfg.encoder_layers):
        x = body(x, p)
    return C.rms_norm(x, enc["final_norm"])


def encdec_forward(params, tokens: torch.Tensor, frames: torch.Tensor,
                   cfg: C.ModelConfig):
    """Encoder-decoder forward: (B, S) tokens + (B, Se, d) frames ->
    (logits, {}); a cross-attention block after each decoder layer."""
    enc_out = encode(params, frames, cfg)
    x = embed_tokens(params, tokens, cfg)
    per = _period(cfg)
    n_full, tail = _split_layers(cfg)

    def superblock(x, layer_params, cross_p):
        layer_params, cross_p = C.gather_fsdp((layer_params, cross_p))
        for kind, p in zip(per, layer_params):
            x, _ = apply_block(kind, p, x, cfg)
        return x + A.cross_attn_block(cross_p, x, A.encoder_kv(cross_p, enc_out, cfg), cfg)

    body = _remat(superblock, cfg)
    for layer_params, cross_p in zip(_unstack(params["stack"]["period"], n_full),
                                     _unstack(params["cross"]["period"], n_full)):
        x = body(x, layer_params, cross_p)
    for kind, p, cross_p in zip(tail, params["stack"]["tail"], params["cross"]["tail"]):
        p, cross_p = C.gather_fsdp((p, cross_p))
        x, _ = apply_block(kind, p, x, cfg)
        x = x + A.cross_attn_block(cross_p, x, A.encoder_kv(cross_p, enc_out, cfg), cfg)
    x = C.rms_norm(x, params["stack"]["final_norm"])
    return logits_from_hidden(params, x, cfg), {}


# ---------------------------------------------------------------------------
# Decode (one token, per-layer caches, unrolled layers)
# ---------------------------------------------------------------------------


def _ring_cache(cfg: C.ModelConfig) -> bool:
    """True when every attention layer is sliding-window: the KV cache is a
    window-sized ring buffer with per-slot absolute positions."""
    attn_kinds = [k for k in cfg.pattern if k in ATTN_KINDS]
    return bool(attn_kinds) and all(k == "swa" for k in attn_kinds) \
        and cfg.window_size > 0


def init_cache(cfg: C.ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """Heterogeneous decode cache, as the reference's: ``kv`` for the
    attention layers (a window-sized ring buffer when every one is
    sliding-window), ``ssm`` {conv, ssm} for the Mamba layers and ``rec``
    {conv, h} for the RG-LRU ones, each stacked over its kind's layers.
    ``len`` is a 0-dim int32 tensor on the host, so reading it costs no
    device synchronization."""
    kinds = cfg.pattern
    n_attn = sum(1 for k in kinds if k in ATTN_KINDS)
    n_ssm = sum(1 for k in kinds if k == "mamba")
    n_rec = sum(1 for k in kinds if k == "rglru")
    cache: dict[str, Any] = {"len": torch.zeros((), dtype=torch.int32)}
    if n_attn:
        size = min(max_len, cfg.window_size) if _ring_cache(cfg) else max_len
        cache["kv"] = A.init_kv_cache(cfg, batch, size, n_attn, device)
    if n_ssm:
        cache["ssm"] = S.init_ssm_cache(cfg, batch, n_ssm, device)
    if n_rec:
        cache["rec"] = R.init_rglru_cache(cfg, batch, n_rec, device)
    return cache


def _layer_params(params, cfg: C.ModelConfig, i: int):
    """Extract layer i's params from the period/tail structure."""
    per = _period(cfg)
    n_full, _ = _split_layers(cfg)
    n_scanned = n_full * len(per)
    if i < n_scanned:
        block_idx, pos = divmod(i, len(per))
        return _index(params["period"][pos], block_idx)
    return params["tail"][i - n_scanned]


def decode_step(params, token: torch.Tensor, cache: dict, cfg: C.ModelConfig):
    """One decode step. token: (B, 1) -> (logits (B,1,V), new_cache).  Walks
    the kinds with one layer counter each, as the reference does.  The
    input cache is not written: the step clones each of its stacks once
    and each layer writes its new k / v slot, or its new states, into its
    slice of the copy."""
    x = embed_tokens(params, token, cfg)
    clen = int(cache["len"])
    ring = _ring_cache(cfg)
    new_cache: dict[str, Any] = dict(cache)
    kv = ssm = rec = None
    if "kv" in cache:
        kv = {"k": cache["kv"]["k"].clone(), "v": cache["kv"]["v"].clone(),
              "pos": cache["kv"]["pos"].clone() if ring else cache["kv"]["pos"]}
        new_cache["kv"] = kv
    if "ssm" in cache:
        ssm = new_cache["ssm"] = {k: t.clone() for k, t in cache["ssm"].items()}
    if "rec" in cache:
        rec = new_cache["rec"] = {k: t.clone() for k, t in cache["rec"].items()}
    i_attn = i_ssm = i_rec = 0
    for i, kind in enumerate(cfg.pattern):
        p = C.gather_fsdp(_layer_params(params["stack"], cfg, i))
        if kind in ATTN_KINDS:
            window = cfg.window_size if kind == "swa" else 0
            out, _, _, _ = A.attn_decode_block(
                p["mixer"], x, kv["k"][i_attn], kv["v"][i_attn], clen, cfg,
                window=window, cache_pos=kv["pos"] if ring else None)
            x = x + out
            if kind == "moe":
                out, _ = M.moe_block(p["moe"], x, cfg)
                x = x + out
            else:
                x = x + mlp_block(p["mlp"], x, cfg)
            i_attn += 1
        elif kind == "mamba":
            out, ssm["conv"][i_ssm], ssm["ssm"][i_ssm] = S.ssm_decode_block(
                p["mixer"], x, ssm["conv"][i_ssm], ssm["ssm"][i_ssm], cfg)
            x = x + out
            i_ssm += 1
        elif kind == "rglru":
            out, rec["conv"][i_rec], rec["h"][i_rec] = R.rglru_decode_block(
                p["mixer"], x, rec["conv"][i_rec], rec["h"][i_rec], cfg)
            x = x + out
            x = x + mlp_block(p["mlp"], x, cfg)
            i_rec += 1
    x = C.rms_norm(x, params["stack"]["final_norm"])
    logits = logits_from_hidden(params, x, cfg)
    new_cache["len"] = torch.tensor(clen + 1, dtype=torch.int32)
    return logits, new_cache
