"""Mamba-1 selective SSM block (falcon-mamba-7b backbone), PyTorch port of
:mod:`repro.models.ssm`.

Prefill runs the diagonal recurrence h_t = dA_t * h_{t-1} + dB_t x_t over
the whole sequence at log depth (:func:`repro_torch.models.common.
linear_scan_`, the odd/even recursion of the reference's
``jax.lax.associative_scan``); decode carries (conv_state, ssm_state) and
costs O(1) per token.  The (B, S, d_inner, d_state) float32 terms are
built in place and freed when the block returns.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as C


def _d_inner(cfg: C.ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def _dt_rank(cfg: C.ModelConfig) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def ssm_param_specs(cfg: C.ModelConfig) -> dict:
    d = cfg.d_model
    di = _d_inner(cfg)
    ds = cfg.ssm.d_state
    dr = _dt_rank(cfg)
    dc = cfg.ssm.d_conv
    dt = cfg.param_dtype
    return {
        "norm": C.ParamSpec((d,), (None,), torch.float32, "zeros"),
        "w_in": C.ParamSpec((d, 2 * di), ("embed", "rnn"), dt),       # x and z
        "conv_w": C.ParamSpec((dc, di), (None, "rnn"), dt, "small_normal", 0.1),
        "conv_b": C.ParamSpec((di,), ("rnn",), dt, "zeros"),
        "w_x": C.ParamSpec((di, dr + 2 * ds), ("rnn", None), dt),     # dt, B, C
        "w_dt": C.ParamSpec((dr, di), (None, "rnn"), dt),
        "dt_bias": C.ParamSpec((di,), ("rnn",), torch.float32, "ones"),
        "a_log": C.ParamSpec((di, ds), ("rnn", "state"), torch.float32,
                             "small_normal", 0.5),
        "d_skip": C.ParamSpec((di,), ("rnn",), torch.float32, "ones"),
        "w_out": C.ParamSpec((di, d), ("rnn", "embed"), dt),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. x: (B, S, di); w: (K, di).  The reference's
    order: zeros in x's dtype, the K taps added in turn, then the bias."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + s, :] * w[i]
    return out + b


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, with no
    linear cut-off (``F.softplus`` returns x past its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _selective_terms(p, x_conv: torch.Tensor, cfg: C.ModelConfig):
    """dt/B/C projections -> discretized (dA, dBx). x_conv: (B, S, di)."""
    ds = cfg.ssm.d_state
    dr = _dt_rank(cfg)
    proj = torch.einsum("bsd,de->bse", x_conv, p["w_x"])
    dt_r, b_mat, c_mat = torch.split(proj, [dr, ds, proj.shape[-1] - dr - ds], dim=-1)
    dt_full = torch.einsum("bsr,rd->bsd", dt_r, p["w_dt"]).to(torch.float32)
    # (a sharding context reduces the product's partial sums before the bias)
    dt_full = softplus(C.constrain(dt_full, "batch", "seq", "rnn") + p["dt_bias"])  # (B,S,di)
    a = -torch.exp(p["a_log"])                                 # (di, ds)
    dA = torch.exp_(dt_full[..., None] * a)                    # (B,S,di,ds)
    dBx = (dt_full * x_conv.to(torch.float32))[..., None] * \
        b_mat.to(torch.float32)[..., None, :]                  # (B,S,di,ds)
    return dA, dBx, c_mat


def ssm_block(p, x: torch.Tensor, cfg: C.ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba block. x: (B, S, d) -> (B, S, d)."""
    h = C.rms_norm(x, p["norm"])
    xz = torch.einsum("bsd,de->bse", h, p["w_in"])
    xs, z = torch.chunk(xz, 2, dim=-1)
    xs = C.constrain(xs, "batch", "seq", "rnn")
    x_conv = F.silu(C.local_region("ssm.causal_conv", causal_conv, xs, p["conv_w"],
                                   p["conv_b"], whole=(1,)))

    dA, dBx, c_mat = _selective_terms(p, x_conv, cfg)
    hs = C.local_region("ssm.linear_scan", C.linear_scan_, dA, dBx, whole=(1,))  # (B,S,di,ds)
    del dA
    y = torch.einsum("bsdn,bsn->bsd", hs, c_mat.to(torch.float32))
    del hs, dBx
    y = y + p["d_skip"] * x_conv.to(torch.float32)
    y = y.to(x.dtype) * F.silu(z)
    return C.constrain(torch.einsum("bse,ed->bsd", y, p["w_out"]), "batch", "seq", "embed")


def init_ssm_cache(cfg: C.ModelConfig, batch: int, n_layers: int, device=None) -> dict:
    di, ds, dc = _d_inner(cfg), cfg.ssm.d_state, cfg.ssm.d_conv
    return {
        "conv": torch.zeros((n_layers, batch, dc - 1, di), dtype=cfg.param_dtype,
                            device=device),
        "ssm": torch.zeros((n_layers, batch, di, ds), dtype=torch.float32, device=device),
    }


def ssm_decode_block(p, x: torch.Tensor, conv_state: torch.Tensor,
                     ssm_state: torch.Tensor, cfg: C.ModelConfig):
    """One-token decode. x: (B, 1, d); conv_state: (B, K-1, di);
    ssm_state: (B, di, ds).  Returns (out, new_conv, new_ssm), new
    tensors (the states passed in are not written)."""
    h = C.rms_norm(x, p["norm"])
    xz = torch.einsum("bsd,de->bse", h, p["w_in"])
    xs, z = torch.chunk(xz, 2, dim=-1)                         # (B,1,di)
    window = torch.cat([conv_state, xs], dim=1)                # (B,K,di)
    conv = torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"]
    x_conv = F.silu(conv)[:, None, :]                          # (B,1,di)
    new_conv = window[:, 1:, :]

    dA, dBx, c_mat = _selective_terms(p, x_conv, cfg)
    new_ssm = dA[:, 0] * ssm_state + dBx[:, 0]                 # (B,di,ds)
    y = torch.einsum("bdn,bn->bd", new_ssm, c_mat[:, 0].to(torch.float32))
    y = y + p["d_skip"] * x_conv[:, 0].to(torch.float32)
    y = y.to(x.dtype) * F.silu(z[:, 0])
    out = torch.einsum("be,ed->bd", y, p["w_out"])[:, None, :]
    return C.constrain(out, "batch", None, "embed"), new_conv, new_ssm
