"""Hand-written CUDA Bloom-signature kernels and their plain PyTorch versions.

Five kernels carry every Bloom-signature operation of the LazyPIM step and
of the LazySync protocol on the card; the source is
``repro_torch/csrc/bloom.cu`` (one note per
kernel there: the TPU kernel it replaces, what bounds it, what its design
does about that).  Each wrapper here:

* checks device, dtype, shape and contiguity and allocates the outputs;
* on a CPU tensor runs the plain PyTorch version beside it (the CPU path
  and the oracle the kernel is held against);
* on a CUDA tensor launches the kernel, raises if the launch reports an
  error, and adds one to its ``launches`` counter — there is no fallback.

* ``h3_hash`` ports ``_h3_hash_block`` (``repro/kernels/bloom/bloom.py:62``):
  the line table of ``prepare`` / ``pad_trace`` / ``dummy_trace`` and
  LazySync's touched ids;
* ``bloom_insert`` ports ``bloom_insert_pallas`` (``bloom.py:135``): the
  per-window read/write images and the CPUWriteSet banks, two lists or two
  bitmaps a launch;
* ``bloom_query`` ports ``bloom_query_pallas`` (``bloom.py:205``): the
  flush / merge / invalidate membership masks, two bitmaps a launch;
* ``bloom_intersect`` ports ``bloom_intersect_pallas`` (``bloom.py:316``):
  per row, or in its pair-and-any form both conflict checks of a LazyPIM
  window (its two banks against the read image, any register) a launch;
* ``bloom_detect_conflicts`` ports ``bloom_detect_conflicts_pallas``
  (``bloom.py:266``): LazySync's per-address hit-group counts
  (``LazyEmbed.detect_conflicts``), on one of two routes chosen by the spec.

``h3_hash`` and ``bloom_detect_conflicts`` take the ``SignatureSpec`` and
hash with its packed byte tables (``packed_tables_tensor``); their plain
versions hash with the byte-sliced tables, so the oracle shares no
arithmetic with the kernels.

The shared library is built with ``nvcc`` for ``sm_90a`` on first use into
the checkout's ``build/`` directory (:mod:`repro_torch.kernels._build`)
and bound with ``ctypes``; nothing is built or imported at module import.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.signatures import (
    SignatureSpec,
    h3_columns,
    hash_with_tables,
    pack_words,
    packed_tables_tensor,
    tables_tensor,
    unpack_words,
)
from repro_torch.kernels import _build

__all__ = [
    "h3_hash", "bloom_insert", "bloom_query", "bloom_intersect",
    "bloom_detect_conflicts", "h3_hash_plain", "bloom_insert_plain",
    "bloom_query_plain", "bloom_intersect_plain",
    "bloom_detect_conflicts_plain", "detect_route",
    "detect_route_counts", "KERNELS", "reset_launch_counts", "launch_counts",
    "query_attributes", "insert_attributes", "hash_attributes", "detect_attributes",
]

SOURCE = _build.CSRC / "bloom.cu"


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "h3_hash_launch": [_P, _P, _P, _I, _I, _I, _I, _P],
    "h3_hash_attributes": [_P],
    "bloom_insert_ids_launch": [_P, _P, _P, _P, _P, _P, *[_I] * 10, _P],
    "bloom_insert_bitmap_launch": [_P, _P, _P, _P, *[_I] * 10, _P],
    "bloom_insert_attributes": [_P],
    "bloom_query_launch": [_P, _P, _P, _P, _P, _P, *[_I] * 7, _P],
    "bloom_query_attributes": [_P],
    "bloom_intersect_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "bloom_intersect_pair_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "bloom_detect_conflicts_launch": [_P, _P, _P, _P, *[_I] * 8, _P],
    "bloom_detect_conflicts_attributes": [_P],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.bind(SOURCE, _SIGNATURES)


def _launch(name: str, *args, device: torch.device) -> None:
    _build.launch(_lib(), name, *args, device=device)


def _stream(t: torch.Tensor) -> int:
    return _build.stream(t)


# ---------------------------------------------------------------------------
# Argument checks
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _on_cpu(*ts: torch.Tensor) -> bool:
    """True for an all-CPU call (plain path); False for an all-CUDA call
    (kernel path); anything else raises — no silent device fallback."""
    return _build.on_cpu("Bloom kernels", *ts)


# The parity-form kernels take the H3 column masks by value in a struct of
# this many words (csrc/h3_parity.cuh); a spec with more (M * log2 seg_bits)
# is hashed in passes of whole segments, each a launch.
MAX_COLUMNS = 512
# A block's shared memory on the H100 (opt-in), which holds a query's
# signature or image and an insert block's slice of its output.
MAX_SMEM_BYTES = 227 * 1024
# An insert cluster: at most 8 blocks, and the bitmap form's line queues
# (8 warps x 256 lines) beside each block's slice.
MAX_CLUSTER, INSERT_QUEUE_BYTES = 8, 8 * 256 * 4


def _check_positions(spec: SignatureSpec) -> None:
    """Positions are int32 on the PyTorch side and uint32 in the kernels:
    every bit of the signature must have one."""
    if spec.sig_bits > 2**31:
        raise ValueError(f"{spec}: the kernels address at most 2**31 signature bits")


@functools.lru_cache(maxsize=None)
def _columns(spec: SignatureSpec) -> tuple[np.ndarray, int]:
    """The spec's (M, log2 seg_bits) column masks as a C-contiguous uint32
    array, and log2 seg_bits."""
    _check_positions(spec)
    cols = np.ascontiguousarray(h3_columns(spec))
    return cols, cols.shape[1]


@functools.lru_cache(maxsize=None)
def _passes(spec: SignatureSpec) -> tuple[tuple[tuple[np.ndarray, int], ...], int]:
    """The launches a parity-form kernel hashes ``spec`` in: ((column masks
    of a run of whole segments, C-contiguous, whose address the launcher
    copies from; the run's first segment), ...) of at most ``MAX_COLUMNS``
    masks each, and log2 seg_bits.  One pass for every spec up to 512
    masks (the paper's is 36)."""
    cols, log_seg = _columns(spec)
    per = MAX_COLUMNS // log_seg
    runs = tuple((np.ascontiguousarray(cols[m0:m0 + per]), m0)
                 for m0 in range(0, cols.shape[0], per))
    return runs, log_seg


def _check_smem(what: str, nbytes: int, room: int = MAX_SMEM_BYTES) -> None:
    if nbytes > room:
        raise ValueError(f"{what} takes {nbytes} bytes of shared memory, past the "
                         f"{room} a kernel has for it")


def _check_spec(spec) -> None:
    if not isinstance(spec, SignatureSpec):
        raise TypeError(f"spec: expected a SignatureSpec, got {type(spec).__name__}")


def _packed(spec: SignatureSpec, device: torch.device) -> tuple[torch.Tensor, int, int]:
    """The spec's packed byte tables on ``device`` (what ``h3_hash`` and
    ``bloom_detect_conflicts`` hash with), the byte slices the kernels read
    and log2 seg_bits.  A line id is 32 bits: the slices past the fourth
    see its zero bytes, whose entries are zero, so a spec of more address
    bits hashes with its first four (``tests/test_torch_hash_detect.py``)."""
    _check_positions(spec)
    slices = min(spec.num_byte_slices, 4)
    return packed_tables_tensor(spec, device), slices, spec.seg_bits.bit_length() - 1


# ---------------------------------------------------------------------------
# h3_hash
# ---------------------------------------------------------------------------


def h3_hash_plain(spec: SignatureSpec, addrs: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`h3_hash` (same arguments and result), through
    the byte-sliced tables."""
    return hash_with_tables(addrs, tables_tensor(spec, addrs.device))


def h3_hash(spec: SignatureSpec, addrs: torch.Tensor) -> torch.Tensor:
    """H3 of ``spec``: (N,) int32 addresses (uint32 bits) -> (N,
    num_segments) int32 global bit positions.

    Ports ``_h3_hash_block`` (``src/repro/kernels/bloom/bloom.py:62``);
    its bound and design are noted in ``csrc/bloom.cu``."""
    _check_spec(spec)
    _check("addrs", addrs, torch.int32, 1)
    if _on_cpu(addrs):
        return h3_hash_plain(spec, addrs)
    ptab, s, log_seg = _packed(spec, addrs.device)
    n = addrs.shape[0]
    out = torch.empty((n, spec.num_segments), dtype=torch.int32, device=addrs.device)
    if n:
        _launch("h3_hash_launch", addrs.data_ptr(), ptab.data_ptr(), out.data_ptr(), n,
                s, spec.num_segments, log_seg, _stream(addrs), device=addrs.device)
        h3_hash.launches += 1
    return out


h3_hash.launches = 0


# ---------------------------------------------------------------------------
# bloom_insert
# ---------------------------------------------------------------------------


def _stage_and_pack(lane, reg, pos, lanes, num_regs, num_words):
    """Scatter (lane, register, position) triples into packed registers."""
    sig_bits = num_words * 32
    flat = (lane * num_regs + reg)[:, None] * sig_bits + pos.to(torch.int64)
    staged = torch.zeros((lanes * num_regs * sig_bits,), dtype=torch.bool,
                         device=pos.device)
    staged[flat.reshape(-1)] = True
    return pack_words(staged.reshape(lanes, num_regs, sig_bits))


def _insert_plain(spec, ids, valid, bitmap, num_lines, num_regs):
    """One list or bitmap through the byte-sliced tables."""
    if ids is not None:
        lanes = ids.shape[0]
        lane, slot = torch.nonzero(valid, as_tuple=True)
        addr = ids[lane, slot]
    else:
        lanes = bitmap.shape[0]
        bits = unpack_words(bitmap, num_lines)
        lane, addr = torch.nonzero(bits, as_tuple=True)
    a64 = addr.to(torch.int64) & 0xFFFFFFFF
    pos = hash_with_tables(addr, tables_tensor(spec, addr.device))
    return _stage_and_pack(lane, a64 % num_regs, pos, lanes, num_regs, spec.num_words)


def _check_insert_bank(words: int, bitmap: bool) -> None:
    """A (list, lane)'s output words over a cluster of at most
    ``MAX_CLUSTER`` blocks must fit their shared memory."""
    room = MAX_SMEM_BYTES - (INSERT_QUEUE_BYTES if bitmap else 0)
    _check_smem(f"an insert output of {words} words over {MAX_CLUSTER} blocks",
                -(-words // MAX_CLUSTER) * 4, room)


def bloom_insert_plain(spec: SignatureSpec, *,
                       ids: torch.Tensor | None = None,
                       valid: torch.Tensor | None = None,
                       bitmap: torch.Tensor | None = None,
                       num_lines: int = 0, num_regs: int = 1,
                       ids_b: torch.Tensor | None = None,
                       valid_b: torch.Tensor | None = None,
                       bitmap_b: torch.Tensor | None = None):
    """Plain version of :func:`bloom_insert` (same arguments and result),
    hashing with the byte-sliced tables."""
    one = _insert_plain(spec, ids, valid, bitmap, num_lines, num_regs)
    if ids_b is None and bitmap_b is None:
        return one
    return one, _insert_plain(spec, ids_b, valid_b, bitmap_b, num_lines, num_regs)


def _check_ids(name: str, ids: torch.Tensor, valid: torch.Tensor) -> None:
    _check(name, ids, torch.int32, 2)
    _check(f"valid for {name}", valid, torch.bool, 2)
    if valid.shape != ids.shape:
        raise ValueError(f"valid {tuple(valid.shape)} != {name} {tuple(ids.shape)}")


def bloom_insert(spec: SignatureSpec, *,
                 ids: torch.Tensor | None = None,
                 valid: torch.Tensor | None = None,
                 bitmap: torch.Tensor | None = None,
                 num_lines: int = 0, num_regs: int = 1,
                 ids_b: torch.Tensor | None = None,
                 valid_b: torch.Tensor | None = None,
                 bitmap_b: torch.Tensor | None = None):
    """Packed Bloom images (L, num_regs, spec.num_words) int32 of

    * an id list: ``ids`` (L, A) int32 with ``valid`` (L, A) bool — invalid
      slots are skipped before hashing; or
    * a packed line bitmap: ``bitmap`` (L, ceil(num_lines/32)) int32 — every
      set line < ``num_lines``.

    Each address goes to register ``address % num_regs`` (``num_regs=16``
    with a bitmap is the CPUWriteSet bank of ``prep.bank_bits_from_bitmap``;
    ``num_regs=1`` a single PIMReadSet/PIMWriteSet image).  Given a second
    list ``ids_b`` / ``valid_b`` (L, A_b) or a second bitmap ``bitmap_b`` of
    the same shape, returns the pair of images from the same launch (one
    count).

    Ports ``bloom_insert_pallas`` (``src/repro/kernels/bloom/bloom.py:135``);
    its bound and design are noted in ``csrc/bloom.cu``."""
    _check_spec(spec)
    if (ids is None) == (bitmap is None):
        raise ValueError("bloom_insert takes exactly one of ids= or bitmap=")
    if num_regs < 1:
        raise ValueError(f"num_regs={num_regs} must be >= 1")
    if ids is not None:
        if bitmap_b is not None:
            raise ValueError("bitmap_b= pairs with bitmap=, not ids=")
        _check_ids("ids", ids, valid)
        inputs = (ids, valid)
        if ids_b is not None:
            _check_ids("ids_b", ids_b, valid_b)
            if ids_b.shape[0] != ids.shape[0]:
                raise ValueError(f"ids_b lanes {ids_b.shape[0]} != ids lanes "
                                 f"{ids.shape[0]}")
            inputs += (ids_b, valid_b)
        second, src = ids_b, ids
    else:
        if ids_b is not None:
            raise ValueError("ids_b= pairs with ids=, not bitmap=")
        _check("bitmap", bitmap, torch.int32, 2)
        if bitmap.shape[1] != (num_lines + 31) // 32:
            raise ValueError(f"bitmap width {bitmap.shape[1]} != "
                             f"ceil(num_lines/32) for num_lines={num_lines}")
        inputs = (bitmap,)
        if bitmap_b is not None:
            _check("bitmap_b", bitmap_b, torch.int32, 2)
            if bitmap_b.shape != bitmap.shape:
                raise ValueError(f"bitmap_b {tuple(bitmap_b.shape)} != bitmap "
                                 f"{tuple(bitmap.shape)}")
            inputs += (bitmap_b,)
        second, src = bitmap_b, bitmap
    if _on_cpu(*inputs):
        return bloom_insert_plain(spec, ids=ids, valid=valid, bitmap=bitmap,
                                  num_lines=num_lines, num_regs=num_regs, ids_b=ids_b,
                                  valid_b=valid_b, bitmap_b=bitmap_b)
    lanes = src.shape[0]
    passes, log_seg = _passes(spec)
    _check_insert_bank(num_regs * spec.num_words, bitmap=ids is None)
    pair = second is not None
    out = torch.empty((1 + pair, lanes, num_regs, spec.num_words), dtype=torch.int32,
                      device=src.device)
    if lanes:  # every output word is written by the kernel: no fill
        for i, (cols, m0) in enumerate(passes):
            geometry = (cols.shape[0], log_seg, m0, int(i > 0), num_regs, spec.num_words,
                        _stream(src))
            if ids is not None:
                _launch("bloom_insert_ids_launch", ids.data_ptr(), valid.data_ptr(),
                        ids_b.data_ptr() if pair else None,
                        valid_b.data_ptr() if pair else None, cols.ctypes.data,
                        out.data_ptr(), out.shape[0], lanes, ids.shape[1],
                        ids_b.shape[1] if pair else 0, *geometry, device=src.device)
            else:
                _launch("bloom_insert_bitmap_launch", bitmap.data_ptr(),
                        bitmap_b.data_ptr() if pair else None, cols.ctypes.data,
                        out.data_ptr(), out.shape[0], lanes, bitmap.shape[1], num_lines,
                        *geometry, device=src.device)
            bloom_insert.launches += 1
    return (out[0], out[1]) if pair else out[0]


bloom_insert.launches = 0


# ---------------------------------------------------------------------------
# bloom_query
# ---------------------------------------------------------------------------


def bloom_query_plain(spec: SignatureSpec, sig: torch.Tensor, words: torch.Tensor,
                      num_lines: int, words_b: torch.Tensor | None = None):
    """Plain version of :func:`bloom_query` (same arguments and result),
    hashing with the byte-sliced tables."""
    union = words if words_b is None else words | words_b
    bits = unpack_words(union, num_lines)
    lane, line = torch.nonzero(bits, as_tuple=True)
    pos = hash_with_tables(line, tables_tensor(spec, sig.device)).to(torch.int64)
    w = sig[lane[:, None], pos >> 5]
    member = (((w >> (pos & 31)) & 1) != 0).all(1)
    hit = torch.zeros_like(bits)
    hit[lane[member], line[member]] = True
    packed = pack_words(hit)
    return packed & words if words_b is None else (packed & words, packed & words_b)


def bloom_query(spec: SignatureSpec, sig: torch.Tensor, words: torch.Tensor,
                num_lines: int, words_b: torch.Tensor | None = None):
    """Packed membership of the lines set in ``words``: bit ``i`` of lane
    ``l`` is set iff line ``i < num_lines`` is set in ``words[l]`` and all M
    of its H3 positions are set in ``sig[l]`` (real false positives).
    ``sig`` (L, NW) int32, ``words`` (L, ceil(num_lines/32)) int32 ->
    (L, ceil(num_lines/32)) int32 with zero pad bits.  Given ``words_b`` of
    the same shape, returns ``(words & member, words_b & member)`` from the
    same launch (one count).

    Ports ``bloom_query_pallas`` (``src/repro/kernels/bloom/bloom.py:205``);
    its bound and design are noted in ``csrc/bloom.cu``."""
    _check_spec(spec)
    _check("sig", sig, torch.int32, 2)
    _check("words", words, torch.int32, 2)
    if sig.shape[1] != spec.num_words:
        raise ValueError(f"sig {tuple(sig.shape)}: want (L, {spec.num_words})")
    if sig.shape[0] != words.shape[0]:
        raise ValueError(f"sig lanes {sig.shape[0]} != words lanes {words.shape[0]}")
    if words.shape[1] != (num_lines + 31) // 32:
        raise ValueError(f"words width {words.shape[1]} != ceil(num_lines/32) "
                         f"for num_lines={num_lines}")
    inputs = (sig, words)
    if words_b is not None:
        _check("words_b", words_b, torch.int32, 2)
        if words_b.shape != words.shape:
            raise ValueError(f"words_b {tuple(words_b.shape)} != words "
                             f"{tuple(words.shape)}")
        inputs += (words_b,)
    if _on_cpu(*inputs):
        return bloom_query_plain(spec, sig, words, num_lines, words_b)
    passes, log_seg = _passes(spec)
    _check_smem(f"a {spec.sig_bits}-bit signature", spec.num_words * 4)
    out, out_b = words, words_b
    if words.numel():
        # a later pass asks only for the lines the last one kept (its outputs)
        for cols, m0 in passes:
            src, src_b = out, out_b
            out = torch.empty_like(words)
            out_b = None if words_b is None else torch.empty_like(words_b)
            _launch("bloom_query_launch", sig.data_ptr(), src.data_ptr(),
                    None if src_b is None else src_b.data_ptr(),
                    cols.ctypes.data, out.data_ptr(),
                    None if out_b is None else out_b.data_ptr(), words.shape[0],
                    words.shape[1], num_lines, cols.shape[0], log_seg, m0,
                    spec.num_words, _stream(sig), device=sig.device)
            bloom_query.launches += 1
    else:
        out = torch.empty_like(words)
        out_b = None if words_b is None else torch.empty_like(words_b)
    return out if words_b is None else (out, out_b)


bloom_query.launches = 0


# ---------------------------------------------------------------------------
# bloom_intersect
# ---------------------------------------------------------------------------


def bloom_intersect_plain(a: torch.Tensor, b: torch.Tensor, num_segments: int,
                          a_b: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`bloom_intersect` (same arguments and result)."""
    if a_b is not None:
        lanes = b.shape[0]
        return torch.stack([bloom_intersect_plain(x, b, num_segments).reshape(lanes, -1).any(1)
                            for x in (a, a_b)])
    rows, nw = a.shape
    per = rows // b.shape[0]
    inter = a.reshape(b.shape[0], per, nw) & b[:, None, :]
    seg = inter.reshape(rows, num_segments, nw // num_segments)
    return (seg != 0).any(2).all(1)


def bloom_intersect(a: torch.Tensor, b: torch.Tensor, num_segments: int, *,
                    a_b: torch.Tensor | None = None) -> torch.Tensor:
    """AND-prefilter: ``a`` (B, NW), ``b`` (L, NW) int32 with ``B % L == 0``;
    row ``i`` of ``a`` pairs with row ``i // (B // L)`` of ``b`` (so a
    CPUWriteSet bank of ``R = B // L`` registers per lane meets its lane's
    read image).  -> (B,) bool, True iff every segment of the AND is
    non-empty.

    Given ``a_b`` (a second bank, shaped as ``a``), the pair-and-any form:
    -> (2, L) bool, entry (k, l) True iff ANY of the R registers of lane l
    in bank k (``a``, then ``a_b``) passes against ``b[l]``; one launch for
    both banks and their reductions over registers.

    Ports ``bloom_intersect_pallas``
    (``src/repro/kernels/bloom/bloom.py:316``); its bound and design are
    noted in ``csrc/bloom.cu``."""
    _check("a", a, torch.int32, 2)
    _check("b", b, torch.int32, 2)
    rows, nw = a.shape
    if b.shape[1] != nw or b.shape[0] == 0 or rows % b.shape[0]:
        raise ValueError(f"bloom_intersect: a {tuple(a.shape)} vs b {tuple(b.shape)}")
    if num_segments < 1 or nw % num_segments:
        raise ValueError(f"num_segments={num_segments} must divide {nw} words")
    if a_b is not None:
        _check("a_b", a_b, torch.int32, 2)
        if a_b.shape != a.shape:
            raise ValueError(f"bloom_intersect: a_b {tuple(a_b.shape)} vs a {tuple(a.shape)}")
        if rows == 0:
            raise ValueError("bloom_intersect: the pair form needs at least one "
                             "register a lane")
    if _on_cpu(a, b, *(() if a_b is None else (a_b,))):
        return bloom_intersect_plain(a, b, num_segments, a_b)
    lanes = b.shape[0]
    if a_b is not None:
        out = torch.empty((2, lanes), dtype=torch.bool, device=a.device)
        _launch("bloom_intersect_pair_launch", a.data_ptr(), a_b.data_ptr(), b.data_ptr(),
                out.data_ptr(), lanes, rows // lanes, nw, nw // num_segments,
                num_segments, _stream(a), device=a.device)
        bloom_intersect.launches += 1
        return out
    out = torch.empty((rows,), dtype=torch.bool, device=a.device)
    if rows:
        _launch("bloom_intersect_launch", a.data_ptr(), b.data_ptr(),
                out.data_ptr(), rows, rows // lanes, nw,
                nw // num_segments, num_segments, _stream(a), device=a.device)
        bloom_intersect.launches += 1
    return out


bloom_intersect.launches = 0


# ---------------------------------------------------------------------------
# bloom_detect_conflicts
# ---------------------------------------------------------------------------


def bloom_detect_conflicts_plain(spec: SignatureSpec, sigs: torch.Tensor,
                                 addrs: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`bloom_detect_conflicts` (same arguments and
    result), hashing with the byte-sliced tables."""
    pos = h3_hash_plain(spec, addrs).to(torch.int64)          # (N, M)
    w = sigs[:, pos >> 5]                                      # (G, N, M)
    member = (((w >> (pos & 31)) & 1) != 0).all(-1)           # (G, N)
    return member.sum(0, dtype=torch.int32)


# Signatures up to this many bits are staged as per-position group masks
# (their words and 2 bytes a bit of shared memory: 128 KB at 16 groups);
# larger ones take the direct route.
DETECT_TRANSPOSED_MAX_BITS = 2**15
DETECT_ROUTES = ("transposed", "direct")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The card's SM count, which sizes the kernel's one-wave grid."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def detect_route(spec: SignatureSpec) -> str:
    """The route ``bloom_detect_conflicts`` takes on the card for ``spec``:
    ``"transposed"`` (each position tested against all G groups with one
    lookup in masks staged in shared memory) up to
    ``DETECT_TRANSPOSED_MAX_BITS`` signature bits, ``"direct"`` (each
    position reads its word of every group) past them."""
    return "transposed" if spec.sig_bits <= DETECT_TRANSPOSED_MAX_BITS else "direct"


def bloom_detect_conflicts(spec: SignatureSpec, sigs: torch.Tensor,
                           addrs: torch.Tensor) -> torch.Tensor:
    """Hit-group counts: ``sigs`` (G, spec.num_words) int32 packed group
    signatures, ``addrs`` (N,) int32 addresses (uint32 bits) -> (N,) int32,
    the number of group signatures holding all M of the address's H3
    positions (LazySync flags a conflict at >= 2).  On the card the route
    (:func:`detect_route`) is chosen by the spec before the launch and
    counted (:func:`detect_route_counts`).

    Ports ``bloom_detect_conflicts_pallas``
    (``src/repro/kernels/bloom/bloom.py:266``); its bound and design are
    noted in ``csrc/bloom.cu``."""
    _check_spec(spec)
    _check("sigs", sigs, torch.int32, 2)
    _check("addrs", addrs, torch.int32, 1)
    g, nw = sigs.shape
    if nw != spec.num_words:
        raise ValueError(f"sigs {tuple(sigs.shape)}: want (G, {spec.num_words})")
    if not 1 <= g <= 16:
        raise ValueError(f"sigs: {g} groups, the kernel takes 1 to 16")
    if _on_cpu(sigs, addrs):
        return bloom_detect_conflicts_plain(spec, sigs, addrs)
    ptab, s, log_seg = _packed(spec, addrs.device)
    route = detect_route(spec)
    n = addrs.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=addrs.device)
    if n:
        _launch("bloom_detect_conflicts_launch", sigs.data_ptr(), addrs.data_ptr(),
                ptab.data_ptr(), out.data_ptr(), n, g, nw, s, spec.num_segments, log_seg,
                int(route == "transposed"), _sm_count(addrs.device), _stream(addrs),
                device=addrs.device)
        bloom_detect_conflicts.launches += 1
        bloom_detect_conflicts.route_launches[route] += 1
    return out


bloom_detect_conflicts.launches = 0
bloom_detect_conflicts.route_launches = dict.fromkeys(DETECT_ROUTES, 0)


def detect_route_counts() -> dict[str, int]:
    """``bloom_detect_conflicts`` launches by route since the last reset;
    they add up to ``launch_counts()["bloom_detect_conflicts"]``."""
    return dict(bloom_detect_conflicts.route_launches)


KERNELS = {"h3_hash": h3_hash, "bloom_insert": bloom_insert,
           "bloom_query": bloom_query, "bloom_intersect": bloom_intersect,
           "bloom_detect_conflicts": bloom_detect_conflicts}


def _attributes(entry: str, builds: tuple[str, ...]) -> dict[str, dict[str, int]]:
    out = (ctypes.c_int * (3 * len(builds)))()
    _build.launch(_lib(), entry, ctypes.addressof(out), device=None)
    keys = ("registers", "local_bytes", "static_smem_bytes")
    return {b: dict(zip(keys, out[3 * i:3 * i + 3])) for i, b in enumerate(builds)}


def hash_attributes() -> dict[str, dict[str, int]]:
    """Registers and local memory a thread and static shared memory a block
    of the loaded ``h3_hash`` kernel, as ``{"paper": ..., "any": ...}``:
    built with the paper's geometry (4 segments of 512 bits, 4 byte slices)
    fixed, and for any other spec."""
    return _attributes("h3_hash_attributes", ("paper", "any"))


def detect_attributes() -> dict[str, dict[str, int]]:
    """The same for the loaded ``bloom_detect_conflicts`` kernel, as
    ``{"paper": ..., "any": ..., "direct": ...}``: the transposed route
    built with the paper's geometry fixed and for any other spec, and the
    direct route."""
    return _attributes("bloom_detect_conflicts_attributes", ("paper", "any", "direct"))


def query_attributes() -> dict[str, dict[str, int]]:
    """Registers and local memory a thread and static shared memory a block
    of the loaded ``bloom_query`` kernel (``cudaFuncGetAttributes``), as
    ``{"paper": ..., "any": ...}``: built with the paper's geometry (M = 4,
    512-bit segments) fixed, and for any other spec.  The column masks are
    a ``__grid_constant__`` parameter, so neither uses local memory."""
    return _attributes("bloom_query_attributes", ("paper", "any"))


def insert_attributes() -> dict[str, dict[str, dict[str, int]]]:
    """The same for the loaded ``bloom_insert`` kernel, as ``{"ids": {"paper":
    ..., "any": ...}, "bitmap": {...}}``: the id-list and bitmap forms, each
    built with the paper's geometry fixed and for any other spec."""
    rows = _attributes("bloom_insert_attributes", ("ids", "ids any", "bitmap", "bitmap any"))
    return {form: {"paper": rows[form], "any": rows[f"{form} any"]}
            for form in ("ids", "bitmap")}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    bloom_detect_conflicts.route_launches = dict.fromkeys(DETECT_ROUTES, 0)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
