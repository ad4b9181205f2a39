"""Public flash attention (the counterpart of
``repro.kernels.flash_attention.ops``): the CUDA kernel of
:mod:`.flash_attention` on CUDA tensors, its plain PyTorch version on CPU
tensors.  The tensors' device selects; there is no ``use_pallas`` switch."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as _k


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, Hq, D), k / v (B, Sk, Hkv, D) -> (B, Sq, Hq, D)."""
    return _k.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, window=window)
