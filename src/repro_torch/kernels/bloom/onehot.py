"""The seed one-hot Bloom kernels (hand-written CUDA) and their plain
PyTorch versions.

Two kernels carry the Bloom primitives of the seed reference simulator
(:mod:`repro_torch.core._boolref`, through ``prep.*_bool``) on the card;
the source is ``repro_torch/csrc/bloom_onehot.cu`` (the note there says
which TPU kernel each replaces, what bounds it and what its design does
about that):

* ``bloom_insert_onehot`` ports ``bloom_insert_pallas_onehot``
  (``repro/kernels/bloom/bloom.py:367``): the seed path's read/write
  images (``prep.sig_bits_from_ids_bool`` / ``sig_bits_from_bitmap_bool``);
* ``bloom_query_onehot`` ports ``bloom_query_pallas_onehot``
  (``bloom.py:420``): the seed path's membership masks
  (``prep.members_bool`` / ``ids_member_bool``).

The insert hashes with the per-bit xor-fold H3 over ``spec.h3_matrix``
(the TPU kernels' ``_h3_hash_block_xorfold``, ``bloom.py:70``), the query
with its parity form over the column masks ``h3_columns(spec)`` (the same
positions bit for bit); both are lane-batched.
The wrappers follow the rule of :mod:`.bloom`: the plain version for CPU
tensors, the kernel for CUDA tensors (with a raise on a launch error and
one count a launch), a raise on anything mixed, no fallback.  The shared
library is built on first use (:mod:`repro_torch.kernels._build`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.signatures import (
    SignatureSpec,
    h3_matrix_tensor,
    hash_positions_xorfold,
    pack_words,
)
from repro_torch.kernels import _build
from repro_torch.kernels.bloom.bloom import (
    _check,
    _check_lanes,
    _columns,
    _on_cpu,
    _stream,
)

__all__ = ["bloom_insert_onehot", "bloom_query_onehot",
           "bloom_insert_onehot_plain", "bloom_query_onehot_plain", "KERNELS",
           "reset_launch_counts", "launch_counts", "query_attributes"]

SOURCE = _build.CSRC / "bloom_onehot.cu"

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "bloom_insert_onehot_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "bloom_query_onehot_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "bloom_query_onehot_attributes": [_P],
}

# A block stages the H3 matrix and a sig_bits-byte image (the insert) or the
# packed image (the query) in shared memory.
MAX_SIG_BITS = 1 << 17


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.bind(SOURCE, _SIGNATURES)


def _launch(name: str, *args) -> None:
    _build.launch(_lib(), name, *args)


def _check_spec_addrs(spec: SignatureSpec, addrs: torch.Tensor) -> tuple[int, int]:
    if not isinstance(spec, SignatureSpec):
        raise TypeError(f"spec: expected a SignatureSpec, got {type(spec).__name__}")
    if spec.sig_bits > MAX_SIG_BITS or spec.num_segments > 32:
        raise ValueError(f"{spec}: the one-hot kernels take sig_bits <= "
                         f"{MAX_SIG_BITS} and num_segments <= 32")
    if not 1 <= spec.addr_bits <= 32:
        raise ValueError(f"{spec}: addr_bits must be in [1, 32]")
    _check("addrs", addrs, torch.int32, 2)
    _check_lanes(addrs.shape[0])
    return tuple(addrs.shape)


def _positions(spec: SignatureSpec, addrs: torch.Tensor) -> torch.Tensor:
    """(L, N, M) int64 xor-fold positions of (L, N) addresses."""
    lanes, n = addrs.shape
    pos = hash_positions_xorfold(spec, addrs.reshape(-1)).to(torch.int64)
    return pos.reshape(lanes, n, spec.num_segments)


# ---------------------------------------------------------------------------
# bloom_insert_onehot
# ---------------------------------------------------------------------------


def bloom_insert_onehot_plain(spec: SignatureSpec, sig: torch.Tensor,
                              addrs: torch.Tensor,
                              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`bloom_insert_onehot` (same arguments and
    result): the xor-fold positions of the unmasked addresses set in a
    full-width 0/1 image per lane, packed and OR-ed into ``sig``.  Masked
    positions go to a staged extra slot per lane, which is cut off."""
    lanes, n = addrs.shape
    stride = spec.sig_bits + 1
    pos = _positions(spec, addrs)
    keep = pos < spec.sig_bits
    if mask is not None:
        keep = keep & mask[:, :, None]
    base = torch.arange(lanes, dtype=torch.int64, device=addrs.device) * stride
    flat = base[:, None, None] + torch.where(keep, pos, spec.sig_bits)
    image = torch.zeros((lanes * stride,), dtype=torch.bool, device=addrs.device)
    image[flat.reshape(-1)] = True
    return sig | pack_words(image.reshape(lanes, stride)[:, :spec.sig_bits])


def bloom_insert_onehot(spec: SignatureSpec, sig: torch.Tensor,
                        addrs: torch.Tensor,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Seed insert: ``sig`` (L, num_words) int32 packed signatures OR the
    one-hot image of the xor-fold H3 positions of ``addrs`` (L, N) int32
    (uint32 bits) where ``mask`` (L, N) bool is set (every address when
    ``mask`` is None) -> (L, num_words) int32 packed words, as the TPU
    kernel returns them.

    Ports ``bloom_insert_pallas_onehot``
    (``src/repro/kernels/bloom/bloom.py:367``); its bound and design are
    noted in ``csrc/bloom_onehot.cu``."""
    lanes, n = _check_spec_addrs(spec, addrs)
    _check("sig", sig, torch.int32, 2)
    if tuple(sig.shape) != (lanes, spec.num_words):
        raise ValueError(f"sig {tuple(sig.shape)}: want ({lanes}, {spec.num_words})")
    inputs = (sig, addrs)
    if mask is not None:
        _check("mask", mask, torch.bool, 2)
        if mask.shape != addrs.shape:
            raise ValueError(f"mask {tuple(mask.shape)} != addrs {tuple(addrs.shape)}")
        inputs += (mask,)
    if _on_cpu(*inputs):
        return bloom_insert_onehot_plain(spec, sig, addrs, mask)
    out = sig.clone()  # the kernel ORs each lane's image into its signature
    if lanes and n:
        q = h3_matrix_tensor(spec, addrs.device)
        _launch("bloom_insert_onehot_launch", addrs.data_ptr(),
                None if mask is None else mask.data_ptr(), q.data_ptr(),
                out.data_ptr(), lanes, n, spec.num_segments, spec.addr_bits,
                spec.sig_bits, _stream(addrs))
        bloom_insert_onehot.launches += 1
    return out


bloom_insert_onehot.launches = 0


# ---------------------------------------------------------------------------
# bloom_query_onehot
# ---------------------------------------------------------------------------


def bloom_query_onehot_plain(spec: SignatureSpec, bits: torch.Tensor,
                             addrs: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`bloom_query_onehot` (same arguments and
    result): each lane's xor-fold positions gathered from its image."""
    lanes, n = addrs.shape
    pos = _positions(spec, addrs)
    inside = pos < spec.sig_bits
    idx = torch.where(inside, pos, 0).reshape(lanes, -1)
    looked = bits.gather(1, idx).reshape(lanes, n, spec.num_segments)
    return (looked & inside).all(-1)


def bloom_query_onehot(spec: SignatureSpec, bits: torch.Tensor,
                       addrs: torch.Tensor) -> torch.Tensor:
    """Seed query: membership of ``addrs`` (L, N) int32 (uint32 bits) in
    the unpacked signature images ``bits`` (L, sig_bits) bool -> (L, N)
    bool, True iff all M xor-fold H3 positions are set.

    Ports ``bloom_query_pallas_onehot``
    (``src/repro/kernels/bloom/bloom.py:420``), whose wrapper unpacks the
    packed signature into such a 0/1 image before the call (``:436-437``);
    its bound and design are noted in ``csrc/bloom_onehot.cu``."""
    lanes, n = _check_spec_addrs(spec, addrs)
    _check("bits", bits, torch.bool, 2)
    if tuple(bits.shape) != (lanes, spec.sig_bits):
        raise ValueError(f"bits {tuple(bits.shape)}: want ({lanes}, {spec.sig_bits})")
    if _on_cpu(bits, addrs):
        return bloom_query_onehot_plain(spec, bits, addrs)
    cols, log_seg = _columns(spec)
    out = torch.empty((lanes, n), dtype=torch.bool, device=addrs.device)
    if lanes and n:
        _launch("bloom_query_onehot_launch", bits.data_ptr(), addrs.data_ptr(),
                cols.ctypes.data, out.data_ptr(), lanes, n, spec.num_segments,
                log_seg, spec.sig_bits, _stream(addrs))
        bloom_query_onehot.launches += 1
    return out


bloom_query_onehot.launches = 0


KERNELS = {"bloom_insert_onehot": bloom_insert_onehot,
           "bloom_query_onehot": bloom_query_onehot}


def query_attributes() -> dict[str, dict[str, int]]:
    """Registers and local memory a thread and static shared memory a block
    of the loaded ``bloom_query_onehot`` kernel (``cudaFuncGetAttributes``), as
    ``{"paper": ..., "any": ...}``: built with the paper's geometry (M = 4,
    512-bit segments) fixed, and for any other spec.  The column masks are
    a ``__grid_constant__`` parameter, so neither uses local memory."""
    out = (ctypes.c_int * 6)()
    _build.launch(_lib(), "bloom_query_onehot_attributes", ctypes.addressof(out))
    keys = ("registers", "local_bytes", "static_smem_bytes")
    return {"paper": dict(zip(keys, out[:3])), "any": dict(zip(keys, out[3:]))}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
