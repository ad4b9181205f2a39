"""Public LazySync merge (the counterpart of ``repro.kernels.lazy_merge.ops``):
the CUDA kernel of :mod:`.lazy_merge` on CUDA tensors, its plain PyTorch
version on CPU tensors."""

from __future__ import annotations

import torch

from repro_torch.kernels.lazy_merge import lazy_merge as _k


def lazy_merge(rows: torch.Tensor, base: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """rows (G, R, D), base (R, D), valid (R,) -> (R, D) float32 merged rows."""
    return _k.lazy_merge(rows.contiguous(), base.contiguous(),
                         valid.to(torch.bool).contiguous())
