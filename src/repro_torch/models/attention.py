"""GQA attention, PyTorch port of :mod:`repro.models.attention`: chunked
softmax attention (decode) and the flash kernel (train / prefill), plus
cross attention and the cached decode step.

:func:`mha_chunked` (a loop over KV chunks with running max / sum /
accumulator) never materializes an (S, S) score matrix; it is the oracle of
the flash kernel (``kernels/flash_attention/ref.py``) and the attention of
the decode step, whose cache offset, valid length and ring positions the
kernel does not take.  :func:`attn_block` (full-sequence self-attention)
and :func:`cross_attn_block` (decoder queries on the encoder's keys and
values) call :func:`flash_mha`, as the reference's module docstring says
models do (the reference's own blocks call ``mha_chunked``): its forward is
:func:`repro_torch.kernels.flash_attention.ops.mha` — on a CUDA tensor the
hand-written CUDA kernel, on a CPU tensor its plain version, the TPU
kernel's float32 math (ROADMAP §C) — and its backward recomputes
``mha_chunked`` on the saved q, k and v and differentiates it, the
gradient the reference's ``jax.value_and_grad`` takes (the TPU kernel has
no backward).  Both run inside a span (:func:`C.span`, a
``torch.profiler.record_function`` range while a profile records) of
:data:`PROFILE_RANGES`, so a profile can read attention's device time.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models import common as C

NEG_INF = float(torch.finfo(torch.float32).min)
# the profiler ranges of :class:`_FlashMHA`'s forward and backward
PROFILE_RANGES = ("flash_mha.forward", "flash_mha.backward")


def _expand_kv(k: torch.Tensor, q_heads: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hq, D) by repeating each kv head q/kv times."""
    rep = q_heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def mha_chunked(
    q: torch.Tensor,              # (B, Sq, Hq, D)
    k: torch.Tensor,              # (B, Sk, Hkv, D)
    v: torch.Tensor,              # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: torch.Tensor | int = 0,
    kv_chunk: int = 1024,
    kv_valid_len: torch.Tensor | int | None = None,
    k_positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """Flash-style attention; returns (B, Sq, Hq, D).

    ``q_offset``: absolute position of q[0] (decode: cache length so far).
    ``kv_valid_len``: mask KV positions >= this (decode with preallocated cache).
    ``k_positions``: (Sk,) absolute position of each cache slot (ring-buffer
    decode for sliding-window layers); -1 marks empty slots.  The
    probabilities are rounded to ``v.dtype`` before the PV product, as the
    reference rounds them.
    """
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    dev = q.device
    k = _expand_kv(k, hq)
    v = _expand_kv(v, hq)
    scale = d ** -0.5

    kv_chunk = min(kv_chunk, sk)
    n_chunks = -(-sk // kv_chunk)
    pad = n_chunks * kv_chunk - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    kp = None
    if k_positions is not None:
        kp = torch.nn.functional.pad(k_positions, (0, pad), value=-1)
        kp = kp.reshape(n_chunks, kv_chunk)
    q_pos = torch.arange(sq, device=dev) + q_offset
    limit = sk if kv_valid_len is None else kv_valid_len
    qf = q.to(torch.float32)

    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=dev)
    for idx in range(n_chunks):
        kb = k[:, idx * kv_chunk:(idx + 1) * kv_chunk]
        vb = v[:, idx * kv_chunk:(idx + 1) * kv_chunk]
        if kp is None:
            k_pos = idx * kv_chunk + torch.arange(kv_chunk, device=dev)
            valid = k_pos < limit
        else:
            k_pos = kp[idx]
            valid = k_pos >= 0
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.to(torch.float32)) * scale
        mask = torch.ones((sq, kv_chunk), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window > 0:
                mask = mask & (k_pos[None, :] > (q_pos[:, None] - window))
        mask = mask & valid[None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (exp(NEG_INF - NEG_INF) would be NaN)
        m_safe = torch.where(m_new == NEG_INF, 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        alpha = torch.where(m == NEG_INF, 0.0, torch.exp(m - m_safe))
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(vb.dtype).to(torch.float32),
                          vb.to(torch.float32))
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


class _FlashMHA(torch.autograd.Function):
    """B7 forward; the backward differentiates ``mha_chunked``, recomputed
    on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        with C.span(PROFILE_RANGES[0]):
            return flash.mha(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad):
        with C.span(PROFILE_RANGES[1]):
            dq, dk, dv = C.local_region("flash_mha.backward", _mha_chunked_grad,
                                        *ctx.saved_tensors, grad, ctx.causal, ctx.window,
                                        whole=(1,))
        return dq, dk, dv, None, None


def _mha_chunked_grad(q, k, v, grad, causal: bool, window: int):
    """(dq, dk, dv) of ``mha_chunked`` at (q, k, v) against ``grad``.  Batch
    and heads are independent, so under a sharding context it runs on each
    rank's shards whole along the sequence (:func:`C.local_region`)."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out = mha_chunked(*qkv, causal=causal, window=window)
        return torch.autograd.grad(out, qkv, grad)


def _kv_for_sharded_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Under a :func:`~repro_torch.models.common.sharding_ctx` whose rules
    shard the query heads but not the kv heads (8 kv heads on a 16-wide
    ``model`` axis), k and v with each kv head repeated for its query
    heads, as the reference's ``mha_chunked`` repeats them, so B7's heads
    shard with q's; otherwise k and v themselves."""
    if C.active_mesh() is None or k.shape[2] == q.shape[2]:
        return k, v
    b, s, hkv, d = k.shape
    hq = q.shape[2]
    if C.logical_to_spec((None, None, "heads", None), (b, s, hq, d)) == \
            C.logical_to_spec((None, None, "kv_heads", None), (b, s, hkv, d)):
        return k, v

    def rep(t):
        t = C.local_region("attention.repeat_kv", _expand_kv, t, hq)
        return C.constrain(t, "batch", "seq", "heads", None)

    return rep(k), rep(v)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Full-sequence attention, q (B, Sq, Hq, D), k / v (B, Sk, Hkv, D) ->
    (B, Sq, Hq, D): B7 forward (one launch on the card), and a gradient
    where one is needed (:class:`_FlashMHA`)."""
    return _FlashMHA.apply(q, k, v, causal, window)


# ---------------------------------------------------------------------------
# Attention block (GQA + RoPE + optional qk-norm), train / prefill / decode
# ---------------------------------------------------------------------------


def attn_param_specs(cfg: C.ModelConfig, cross: bool = False) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": C.ParamSpec((d, hq, hd), ("embed", "heads", None), cfg.param_dtype),
        "wk": C.ParamSpec((d, hkv, hd), ("embed", "kv_heads", None), cfg.param_dtype),
        "wv": C.ParamSpec((d, hkv, hd), ("embed", "kv_heads", None), cfg.param_dtype),
        "wo": C.ParamSpec((hq, hd, d), ("heads", None, "embed"), cfg.param_dtype),
        "norm": C.ParamSpec((d,), (None,), torch.float32, "zeros"),
    }
    if cfg.qk_norm:
        specs["q_norm"] = C.ParamSpec((hd,), (None,), torch.float32, "zeros")
        specs["k_norm"] = C.ParamSpec((hd,), (None,), torch.float32, "zeros")
    return specs


def _project_qkv(p, x, cfg: C.ModelConfig, positions, use_rope: bool = True):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = C.rms_norm(q, p["q_norm"])
        k = C.rms_norm(k, p["k_norm"])
    if use_rope:
        q = C.rope(q, positions, cfg.rope_theta)
        k = C.rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_block(p, x: torch.Tensor, cfg: C.ModelConfig, *, window: int = 0,
               causal: bool = True, positions=None) -> torch.Tensor:
    """Self-attention over the full sequence (train / prefill). x: (B,S,d)."""
    s = x.shape[1]
    h = C.rms_norm(x, p["norm"])
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, h, cfg, positions)
    q = C.constrain(q, "batch", "seq", "heads", None)
    k = C.constrain(k, "batch", "seq", "kv_heads", None)
    k, v = _kv_for_sharded_heads(q, k, v)
    out = flash_mha(q, k, v, causal=causal, window=window)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return C.constrain(out, "batch", "seq", "embed")


def cross_attn_block(p, x: torch.Tensor, enc_kv, cfg: C.ModelConfig) -> torch.Tensor:
    """Cross-attention: q from decoder x (no RoPE, no qk-norm), k / v
    precomputed from the encoder (:func:`encoder_kv`); non-causal."""
    h = C.rms_norm(x, p["norm"])
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k, v = _kv_for_sharded_heads(q, *enc_kv)
    out = flash_mha(q, k, v, causal=False)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return C.constrain(out, "batch", "seq", "embed")


def encoder_kv(p, enc_out: torch.Tensor, cfg: C.ModelConfig):
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])
    return (k, v)


def init_kv_cache(cfg: C.ModelConfig, batch: int, max_len: int, n_layers: int,
                  device=None) -> dict:
    """Preallocated decode cache: (L, B, S, Hkv, D) k and v + slot positions.

    When every attention layer is sliding-window, ``max_len`` should be the
    window size and the cache acts as a ring buffer (``pos`` tracks the
    absolute position stored in each slot; -1 = empty).
    """
    shape = (n_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.param_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.param_dtype, device=device),
        "pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
    }


def _direct_decode_attention(q, k, v, cache_len, *, window: int = 0,
                             k_positions: torch.Tensor | None = None):
    """One-token attention over the full cache with no kv-chunk loop: a
    grouped-head einsum (no GQA repeat of the cache) -> masked softmax ->
    einsum.  q: (B, 1, Hq, D); k/v: (B, S, Hkv, D)."""
    b, _, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    q5 = q.reshape(b, 1, hkv, g, d)
    if k_positions is None:
        k_pos = torch.arange(sk, device=q.device)
        valid = k_pos < cache_len + 1
    else:
        k_pos = k_positions
        valid = k_pos >= 0
    mask = valid & (k_pos <= cache_len)
    if window > 0:
        mask = mask & (k_pos > (cache_len - window))
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5.to(torch.float32),
                     k.to(torch.float32)) * (d ** -0.5)
    s = torch.where(mask[None, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, 1, hq, d).to(q.dtype)


def _decode_chunked(q, cache_k, cache_v, clen: int, window: int,
                    cache_pos: torch.Tensor | None) -> torch.Tensor:
    """The new token's ``mha_chunked`` over the cache (``clen + 1`` valid
    slots, or the ring's ``cache_pos``)."""
    if cache_pos is not None:
        return mha_chunked(q, cache_k, cache_v, causal=True, window=window,
                           q_offset=clen, kv_chunk=4096, k_positions=cache_pos)
    return mha_chunked(q, cache_k, cache_v, causal=True, window=window,
                       q_offset=clen, kv_chunk=4096, kv_valid_len=clen + 1)


def attn_decode_block(p, x: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, cache_len, cfg: C.ModelConfig, *,
                      window: int = 0, cache_pos: torch.Tensor | None = None):
    """One-token decode step against a preallocated cache slice.

    x: (B, 1, d); cache_k/v: (B, Smax, Hkv, D) for THIS layer; ``cache_len``
    an int or a 0-dim integer tensor on the host.  When the cache is smaller
    than the sequence (sliding-window ring buffer), ``cache_pos`` (Smax,)
    carries each slot's absolute position and the new token overwrites slot
    ``len % Smax``.  The new token's k / v (and position) are written into
    ``cache_k``, ``cache_v`` (and ``cache_pos``) in place — the reference
    returns new arrays; the caller owns the copy (``decode_step`` clones the
    cache once a step).  Returns (out, cache_k, cache_v, cache_pos).
    """
    smax = cache_k.shape[1]
    clen = int(cache_len)
    positions = torch.full((x.shape[0], 1), clen, dtype=torch.int32, device=x.device)
    h = C.rms_norm(x, p["norm"])
    q, k, v = _project_qkv(p, h, cfg, positions)
    slot = clen % smax
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    if cache_pos is not None:
        cache_pos[slot] = clen
    if cfg.decode_direct_attn:
        out = _direct_decode_attention(q, cache_k, cache_v, clen, window=window,
                                       k_positions=cache_pos)
    else:
        # under a sharding context, batch-parallel over the whole cache: a
        # sequence-sharded cache is gathered once a layer, not once a chunk
        out = C.local_region("attention.decode_chunked", _decode_chunked, q, cache_k,
                             cache_v, clen, window, cache_pos, whole=(1, 2))
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return C.constrain(out, "batch", None, "embed"), cache_k, cache_v, cache_pos
