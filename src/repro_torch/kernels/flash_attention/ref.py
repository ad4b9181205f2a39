"""Plain PyTorch oracle for flash attention (the counterpart of
``repro.kernels.flash_attention.ref``): the chunked-softmax attention of
:mod:`repro_torch.models.attention` is the reference."""

from __future__ import annotations

import torch

from repro_torch.models.attention import mha_chunked


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D)."""
    return mha_chunked(q, k, v, causal=causal, window=window)
