"""Plain PyTorch oracle for the signature-level Bloom API (the counterpart
of ``repro.kernels.bloom.ref``).  Canonical semantics live in
:mod:`repro_torch.core.signatures`; :mod:`.ops` computes the same results
through the CUDA kernels of :mod:`.bloom`."""

from __future__ import annotations

import torch

from repro_torch.core import signatures as sig_lib
from repro_torch.core.signatures import SignatureSpec


def bloom_insert_ref(spec: SignatureSpec, sig: torch.Tensor,
                     addrs: torch.Tensor,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """Insert ``addrs`` (N,) into packed signature ``sig`` (num_words,)."""
    return sig_lib.insert(spec, sig, addrs, mask=mask)


def bloom_query_ref(spec: SignatureSpec, sig: torch.Tensor,
                    addrs: torch.Tensor) -> torch.Tensor:
    """Membership of ``addrs`` (N,) in ``sig`` -> (N,) bool."""
    return sig_lib.query(spec, sig, addrs)


def bloom_intersect_ref(spec: SignatureSpec, a: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Batched AND-prefilter: a, b (B, num_words) -> (B,) bool."""
    inter = (a & b).reshape(a.shape[0], spec.num_segments, spec.words_per_seg)
    return (inter != 0).any(2).all(1)
