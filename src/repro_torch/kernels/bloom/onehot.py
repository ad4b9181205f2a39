"""The seed one-hot Bloom kernels (hand-written CUDA) and their plain
PyTorch versions.

Two kernels carry the Bloom primitives of the seed reference simulator
(:mod:`repro_torch.core._boolref`, through ``prep.*_bool``) on the card;
the source is ``repro_torch/csrc/bloom_onehot.cu`` (the note there says
which TPU kernel each replaces, what bounds it and what its design does
about that):

* ``bloom_insert_onehot`` ports ``bloom_insert_pallas_onehot``
  (``repro/kernels/bloom/bloom.py:367``): the seed path's read/write
  images, both from one launch (``prep.sig_bits_pair_from_ids_bool``; also
  ``sig_bits_from_ids_bool`` / ``sig_bits_from_bitmap_bool``);
* ``bloom_query_onehot`` ports ``bloom_query_pallas_onehot``
  (``bloom.py:420``): the seed path's membership masks
  (``prep.members_bool`` / ``ids_member_bool``).

Both kernels hash with the parity form of H3 over the column masks
``h3_columns(spec)``, which gives the positions of the TPU kernels'
per-bit xor-fold (``_h3_hash_block_xorfold``, ``bloom.py:70``) bit for bit;
the plain versions hash with that xor-fold.  Both are lane-batched.
The wrappers follow the rule of :mod:`.bloom`: the plain version for CPU
tensors, the kernel for CUDA tensors (with a raise on a launch error and
one count a launch; a spec of more than 512 column masks launches once a
pass), a raise on anything mixed, no fallback.  The shared
library is built on first use (:mod:`repro_torch.kernels._build`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.signatures import (
    SignatureSpec,
    hash_positions_xorfold,
    pack_words,
)
from repro_torch.kernels import _build
from repro_torch.kernels.bloom.bloom import (
    _check,
    _check_insert_bank,
    _check_smem,
    _on_cpu,
    _passes,
    _stream,
)

__all__ = ["bloom_insert_onehot", "bloom_query_onehot",
           "bloom_insert_onehot_plain", "bloom_query_onehot_plain", "KERNELS",
           "reset_launch_counts", "launch_counts", "query_attributes",
           "insert_attributes"]

SOURCE = _build.CSRC / "bloom_onehot.cu"

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "bloom_insert_onehot_launch": [*[_P] * 7, *[_I] * 9, _P],
    "bloom_insert_onehot_attributes": [_P],
    "bloom_query_onehot_launch": [_P, _P, _P, _P, *[_I] * 7, _P],
    "bloom_query_onehot_attributes": [_P],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.bind(SOURCE, _SIGNATURES)


def _launch(name: str, *args, device: torch.device) -> None:
    _build.launch(_lib(), name, *args, device=device)


def _check_spec_addrs(spec: SignatureSpec, addrs: torch.Tensor) -> tuple[int, int]:
    if not isinstance(spec, SignatureSpec):
        raise TypeError(f"spec: expected a SignatureSpec, got {type(spec).__name__}")
    _check("addrs", addrs, torch.int32, 2)
    return tuple(addrs.shape)


def _positions(spec: SignatureSpec, addrs: torch.Tensor) -> torch.Tensor:
    """(L, N, M) int64 xor-fold positions of (L, N) addresses."""
    lanes, n = addrs.shape
    pos = hash_positions_xorfold(spec, addrs.reshape(-1)).to(torch.int64)
    return pos.reshape(lanes, n, spec.num_segments)


# ---------------------------------------------------------------------------
# bloom_insert_onehot
# ---------------------------------------------------------------------------


def _image_plain(spec: SignatureSpec, addrs: torch.Tensor,
                 mask: torch.Tensor | None) -> torch.Tensor:
    """Packed (L, num_words) image of the unmasked addresses' xor-fold
    positions, set in a full-width 0/1 image per lane.  Masked positions go
    to a staged extra slot per lane, which is cut off."""
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
    return pack_words(image.reshape(lanes, stride)[:, :spec.sig_bits])


def bloom_insert_onehot_plain(spec: SignatureSpec, sig: torch.Tensor | None,
                              addrs: torch.Tensor,
                              mask: torch.Tensor | None = None, *,
                              addrs_b: torch.Tensor | None = None,
                              mask_b: torch.Tensor | None = None):
    """Plain version of :func:`bloom_insert_onehot` (same arguments and
    result), hashing with the xor-fold."""
    images = [_image_plain(spec, addrs, mask)]
    if addrs_b is not None:
        images.append(_image_plain(spec, addrs_b, mask_b))
    if sig is not None:
        images = [sig | img for img in images]
    return images[0] if addrs_b is None else tuple(images)


def _check_mask(name: str, mask: torch.Tensor | None, addrs: torch.Tensor) -> tuple:
    if mask is None:
        return ()
    _check(name, mask, torch.bool, 2)
    if mask.shape != addrs.shape:
        raise ValueError(f"{name} {tuple(mask.shape)} != addrs {tuple(addrs.shape)}")
    return (mask,)


def bloom_insert_onehot(spec: SignatureSpec, sig: torch.Tensor | None,
                        addrs: torch.Tensor,
                        mask: torch.Tensor | None = None, *,
                        addrs_b: torch.Tensor | None = None,
                        mask_b: torch.Tensor | None = None):
    """Seed insert: ``sig`` (L, num_words) int32 packed signatures (None: all
    zero) OR the one-hot image of the H3 positions of ``addrs`` (L, N)
    int32 (uint32 bits) where ``mask`` (L, N) bool is set (every address
    when ``mask`` is None) -> (L, num_words) int32 packed words, as the TPU
    kernel returns them.  Given a second list ``addrs_b`` (L, N_b) with its
    ``mask_b``, returns the pair of signatures (``sig`` ORed into both) from
    the same launch (one count).

    Ports ``bloom_insert_pallas_onehot``
    (``src/repro/kernels/bloom/bloom.py:367``); its bound and design are
    noted in ``csrc/bloom_onehot.cu``."""
    lanes, n = _check_spec_addrs(spec, addrs)
    inputs = (addrs,) + _check_mask("mask", mask, addrs)
    if sig is not None:
        _check("sig", sig, torch.int32, 2)
        if tuple(sig.shape) != (lanes, spec.num_words):
            raise ValueError(f"sig {tuple(sig.shape)}: want ({lanes}, {spec.num_words})")
        inputs += (sig,)
    if addrs_b is not None:
        _check("addrs_b", addrs_b, torch.int32, 2)
        if addrs_b.shape[0] != lanes:
            raise ValueError(f"addrs_b lanes {addrs_b.shape[0]} != addrs lanes {lanes}")
        inputs += (addrs_b,) + _check_mask("mask_b", mask_b, addrs_b)
    elif mask_b is not None:
        raise ValueError("mask_b= needs addrs_b=")
    if _on_cpu(*inputs):
        return bloom_insert_onehot_plain(spec, sig, addrs, mask, addrs_b=addrs_b,
                                         mask_b=mask_b)
    passes, log_seg = _passes(spec)
    _check_insert_bank(spec.num_words, bitmap=False)
    pair = addrs_b is not None
    n_b = addrs_b.shape[1] if pair else 0
    shape = (1 + pair, lanes, spec.num_words)
    if not (lanes and (n or n_b)):  # no address to insert: no launch
        out = torch.zeros(shape, dtype=torch.int32, device=addrs.device)
        out = out if sig is None else out | sig
    else:  # every output word is written by the kernel: no fill, no clone
        out = torch.empty(shape, dtype=torch.int32, device=addrs.device)

        def ptr(t):
            return None if t is None else t.data_ptr()

        for i, (cols, m0) in enumerate(passes):
            _launch("bloom_insert_onehot_launch", addrs.data_ptr(), ptr(mask),
                    ptr(addrs_b), ptr(mask_b), ptr(sig), cols.ctypes.data, out.data_ptr(),
                    out.shape[0], lanes, n, n_b, cols.shape[0], log_seg, m0, int(i > 0),
                    spec.num_words, _stream(addrs), device=addrs.device)
            bloom_insert_onehot.launches += 1
    return (out[0], out[1]) if pair else out[0]


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
    passes, log_seg = _passes(spec)
    _check_smem(f"a {spec.sig_bits}-bit image", spec.num_words * 4)
    out = torch.empty((lanes, n), dtype=torch.bool, device=addrs.device)
    if lanes and n:
        for i, (cols, m0) in enumerate(passes):  # a later pass ANDs into out
            _launch("bloom_query_onehot_launch", bits.data_ptr(), addrs.data_ptr(),
                    cols.ctypes.data, out.data_ptr(), lanes, n, cols.shape[0], log_seg,
                    m0, int(i > 0), spec.sig_bits, _stream(addrs), device=addrs.device)
            bloom_query_onehot.launches += 1
    return out


bloom_query_onehot.launches = 0


KERNELS = {"bloom_insert_onehot": bloom_insert_onehot,
           "bloom_query_onehot": bloom_query_onehot}


def _attributes(entry: str) -> dict[str, dict[str, int]]:
    out = (ctypes.c_int * 6)()
    _build.launch(_lib(), entry, ctypes.addressof(out), device=None)
    keys = ("registers", "local_bytes", "static_smem_bytes")
    return {"paper": dict(zip(keys, out[:3])), "any": dict(zip(keys, out[3:]))}


def insert_attributes() -> dict[str, dict[str, int]]:
    """Registers and local memory a thread and static shared memory a block
    of the loaded ``bloom_insert_onehot`` kernel (``cudaFuncGetAttributes``),
    as ``{"paper": ..., "any": ...}``: built with the paper's geometry
    fixed, and for any other spec."""
    return _attributes("bloom_insert_onehot_attributes")


def query_attributes() -> dict[str, dict[str, int]]:
    """Registers and local memory a thread and static shared memory a block
    of the loaded ``bloom_query_onehot`` kernel (``cudaFuncGetAttributes``), as
    ``{"paper": ..., "any": ...}``: built with the paper's geometry (M = 4,
    512-bit segments) fixed, and for any other spec.  The column masks are
    a ``__grid_constant__`` parameter, so neither uses local memory."""
    return _attributes("bloom_query_onehot_attributes")


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
