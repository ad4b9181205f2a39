"""Plain PyTorch oracle for the LazySync row merge (the counterpart of
``repro.kernels.lazy_merge.ref``), written as the reference writes it:

    merged[r] = base[r] + sum_g (rows[g, r] - base[r])   where valid[r]
    merged[r] = base[r]                                  otherwise
"""

from __future__ import annotations

import torch


def lazy_merge_ref(rows: torch.Tensor, base: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """rows: (G, R, D); base: (R, D); valid: (R,) bool -> (R, D) float32."""
    rows32 = rows.to(torch.float32)
    base32 = base.to(torch.float32)
    merged = base32 + torch.sum(rows32 - base32[None], dim=0)
    return torch.where(valid[:, None], merged, base32)
