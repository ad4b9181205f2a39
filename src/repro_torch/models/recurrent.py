"""RG-LRU recurrent block (RecurrentGemma / Griffin family), PyTorch port
of :mod:`repro.models.recurrent`.

The Griffin recurrent block: two parallel branches — a GeLU gate branch and
a recurrence branch (linear -> short causal conv -> RG-LRU) — multiplied and
projected out.  The RG-LRU diagonal recurrence

    a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x_t))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

runs at log depth over the sequence for prefill
(:func:`repro_torch.models.common.linear_scan_`) and carries (conv_state, h)
for O(1) decode.
"""

from __future__ import annotations

import torch

from repro_torch.models import common as C
from repro_torch.models.ssm import causal_conv, softplus


def rglru_param_specs(cfg: C.ModelConfig) -> dict:
    d = cfg.d_model
    w = cfg.recurrent.lru_width
    dc = cfg.recurrent.d_conv
    dt = cfg.param_dtype
    return {
        "norm": C.ParamSpec((d,), (None,), torch.float32, "zeros"),
        "w_gate": C.ParamSpec((d, w), ("embed", "rnn"), dt),
        "w_rec": C.ParamSpec((d, w), ("embed", "rnn"), dt),
        "conv_w": C.ParamSpec((dc, w), (None, "rnn"), dt, "small_normal", 0.1),
        "conv_b": C.ParamSpec((w,), ("rnn",), dt, "zeros"),
        "w_a": C.ParamSpec((w, w), ("rnn", None), dt, "small_normal", 0.02),
        "w_i": C.ParamSpec((w, w), ("rnn", None), dt, "small_normal", 0.02),
        "lam": C.ParamSpec((w,), ("rnn",), torch.float32, "small_normal", 0.65),
        "w_out": C.ParamSpec((w, d), ("rnn", "embed"), dt),
    }


def _rglru_terms(p, xc: torch.Tensor, cfg: C.ModelConfig):
    """Recurrence coefficients. xc: (B, S, w) -> (a, bx) float32."""
    c = cfg.recurrent.c_exponent
    r = torch.sigmoid(torch.einsum("bsw,wv->bsv", xc, p["w_a"]).to(torch.float32))
    i = torch.sigmoid(torch.einsum("bsw,wv->bsv", xc, p["w_i"]).to(torch.float32))
    log_a = -c * softplus(p["lam"]) * r
    a = torch.exp(log_a)
    gated = i * xc.to(torch.float32)
    bx = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-9)) * gated
    return a, bx


def rglru_block(p, x: torch.Tensor, cfg: C.ModelConfig) -> torch.Tensor:
    """Full-sequence Griffin recurrent block. x: (B,S,d)."""
    h = C.rms_norm(x, p["norm"])
    gate = C.activation("gelu", torch.einsum("bsd,dw->bsw", h, p["w_gate"]))
    rec = torch.einsum("bsd,dw->bsw", h, p["w_rec"])
    rec = C.constrain(rec, "batch", "seq", "rnn")
    xc = C.local_region("rglru.causal_conv", causal_conv, rec, p["conv_w"], p["conv_b"],
                        whole=(1,))

    a, bx = _rglru_terms(p, xc, cfg)
    hs = C.local_region("rglru.linear_scan", C.linear_scan_, a, bx, whole=(1,))
    y = hs.to(x.dtype) * gate
    return C.constrain(torch.einsum("bsw,wd->bsd", y, p["w_out"]), "batch", "seq", "embed")


def init_rglru_cache(cfg: C.ModelConfig, batch: int, n_layers: int, device=None) -> dict:
    w = cfg.recurrent.lru_width
    dc = cfg.recurrent.d_conv
    return {
        "conv": torch.zeros((n_layers, batch, dc - 1, w), dtype=cfg.param_dtype,
                            device=device),
        "h": torch.zeros((n_layers, batch, w), dtype=torch.float32, device=device),
    }


def rglru_decode_block(p, x: torch.Tensor, conv_state: torch.Tensor,
                       h_state: torch.Tensor, cfg: C.ModelConfig):
    """One-token decode. x: (B,1,d); conv_state: (B,K-1,w); h_state: (B,w).
    Returns (out, new_conv, new_h), new tensors."""
    h = C.rms_norm(x, p["norm"])
    gate = C.activation("gelu", torch.einsum("bsd,dw->bsw", h, p["w_gate"]))
    rec = torch.einsum("bsd,dw->bsw", h, p["w_rec"])
    window = torch.cat([conv_state, rec], dim=1)
    xc = (torch.einsum("bkw,kw->bw", window, p["conv_w"]) + p["conv_b"])[:, None, :]
    new_conv = window[:, 1:, :]

    a, bx = _rglru_terms(p, xc, cfg)
    new_h = a[:, 0] * h_state + bx[:, 0]
    y = new_h[:, None, :].to(x.dtype) * gate
    out = torch.einsum("bsw,wd->bsd", y, p["w_out"])
    return C.constrain(out, "batch", None, "embed"), new_conv, new_h
