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


def bloom_detect_conflicts_ref(spec: SignatureSpec, sigs: torch.Tensor,
                               addrs: torch.Tensor) -> torch.Tensor:
    """Hit-group counts: sigs (G, num_words) packed, addrs (N,) -> (N,)
    int32 number of group signatures containing each address (LazySync
    conflicts are counts >= 2)."""
    pos = sig_lib.hash_with_tables(
        addrs, sig_lib.tables_tensor(spec, sigs.device)).to(torch.int64)
    bits = sig_lib.unpack_bits(spec, sigs)                   # (G, sig_bits)
    member = bits[:, pos].all(-1)                            # (G, N)
    return member.to(torch.int32).sum(0, dtype=torch.int32)


def bloom_intersect_ref(spec: SignatureSpec, a: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Batched AND-prefilter: a, b (B, num_words) -> (B,) bool."""
    inter = (a & b).reshape(a.shape[0], spec.num_segments, spec.words_per_seg)
    return (inter != 0).any(2).all(1)
