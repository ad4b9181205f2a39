"""Signature-level Bloom API over the CUDA kernels (the counterpart of
``repro.kernels.bloom.ops``).  On a CUDA tensor every call runs the
kernels of :mod:`.bloom`, the fused LazySync conflict detector
(``bloom_detect_conflicts``) included; on a CPU tensor their plain
PyTorch versions."""

from __future__ import annotations

import torch

from repro_torch.core.signatures import SignatureSpec, hash_positions, to_addr_i32
from repro_torch.kernels.bloom import bloom as _k


def bloom_insert(spec: SignatureSpec, sig: torch.Tensor, addrs: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Insert addresses into a packed signature (num_words,) int32."""
    ids = to_addr_i32(addrs)
    valid = (torch.ones_like(ids, dtype=torch.bool) if mask is None
             else mask.reshape(-1).to(torch.bool).contiguous())
    img = _k.bloom_insert(spec, ids=ids[None, :], valid=valid[None, :])
    return sig | img[0, 0]


def bloom_query(spec: SignatureSpec, sig: torch.Tensor,
                addrs: torch.Tensor) -> torch.Tensor:
    """Membership test -> (N,) bool (``h3_hash`` kernel + word gather)."""
    pos = hash_positions(spec, addrs).to(torch.int64)
    w = sig[pos >> 5]
    return (((w >> (pos & 31)) & 1) != 0).all(1)


def bloom_detect_conflicts(spec: SignatureSpec, sigs: torch.Tensor,
                           addrs: torch.Tensor) -> torch.Tensor:
    """Fused hash + membership across groups + hit count: ``sigs``
    (G, num_words) int32 packed, ``addrs`` (N,) -> (N,) int32 hit-group
    counts (conflict iff >= 2)."""
    if sigs.dim() != 2 or sigs.shape[1] != spec.num_words:
        raise ValueError(f"sigs {tuple(sigs.shape)}: want (G, {spec.num_words}) "
                         f"packed words of a {spec.sig_bits}-bit signature")
    return _k.bloom_detect_conflicts(spec, sigs.contiguous(), to_addr_i32(addrs))


def bloom_intersect(spec: SignatureSpec, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Batched AND-prefilter (B, num_words) x2 -> (B,) bool."""
    return _k.bloom_intersect(a.contiguous(), b.contiguous(), spec.num_segments)
