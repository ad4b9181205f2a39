"""Parallel Bloom-filter coherence signatures (LazyPIM §5.3), PyTorch port
of :mod:`repro.core.signatures`.

An N-bit signature is partitioned into M segments; each segment uses an
independent H3 hash that maps a cache-line address to one bit of the
segment.  The paper's registers are N = 2048 bits, M = 4; the CPUWriteSet
is a bank of 16 such registers.  This module is the bit-exact software
model: the same H3 matrix (drawn with the same numpy call), the same
byte-sliced lookup tables, the same packed word layout.

**Word representation.**  Packed signatures and bitmaps are ``int32``
tensors holding the bits of the reference's ``uint32`` words (torch has
no usable ``uint32`` arithmetic on the CPU).  Every right shift is masked,
and values that need all 32 bits unsigned are computed in ``int64`` with
``& 0xFFFFFFFF`` and folded back with :func:`u32_to_i32`.

**Byte-sliced H3.**  ``h_m(a) = XOR_k T[k][(a >> 8k) & 0xFF][m]`` with the
segment offsets folded into slice 0 (:func:`_h3_tables_global`), so a hash
is four table gathers and three XORs.  On the CUDA card
:func:`hash_positions` runs the ``h3_hash`` kernel
(:mod:`repro_torch.kernels.bloom.bloom`); :func:`hash_with_tables` is its
plain PyTorch version and the CPU path.

**Parity form.**  H3 is linear over GF(2), so bit ``k`` of segment ``m``'s
hash is the parity of ``a & C[m][k]`` with the column masks of
:func:`h3_columns`; the ``bloom_query``, ``bloom_insert`` and seed one-hot
kernels hash this way, and :func:`hash_positions_parity` is its plain
version.

**Packed byte tables.**  The same byte slices with all segments of a byte
packed into one 64-bit word (:func:`packed_tables`): an address is four
gathers and three XORs for every segment at once.  The ``h3_hash`` and
``bloom_detect_conflicts`` kernels hash this way, and
:func:`hash_positions_packed` is its plain version.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np
import torch

__all__ = [
    "SignatureSpec",
    "default_spec",
    "tables_tensor",
    "h3_matrix_tensor",
    "h3_columns",
    "packed_tables",
    "packed_tables_tensor",
    "empty_signature",
    "empty_bank",
    "hash_positions",
    "hash_positions_xorfold",
    "hash_positions_parity",
    "hash_positions_packed",
    "hash_with_tables",
    "insert",
    "insert_bank_round_robin",
    "query",
    "intersect",
    "intersect_nonempty",
    "bank_intersect_nonempty",
    "popcount",
    "saturation",
    "expected_membership_fp_rate",
    "pack_bits",
    "unpack_bits",
    "pack_words",
    "unpack_words",
    "popcount_per_word",
    "u32_to_i32",
]

U32 = 0xFFFFFFFF

if sys.byteorder != "little":
    raise ImportError("repro_torch packs bitmap words as little-endian bytes")


@dataclasses.dataclass(frozen=True)
class SignatureSpec:
    """Geometry + hash family of one coherence signature register (paper
    defaults: 2 Kbit, M = 4, H3 over 32-bit line addresses)."""

    sig_bits: int = 2048
    num_segments: int = 4
    addr_bits: int = 32
    seed: int = 0xC0FFEE

    def __post_init__(self):
        if self.sig_bits % (32 * self.num_segments) != 0:
            raise ValueError(
                f"sig_bits={self.sig_bits} must be a multiple of "
                f"32*num_segments={32 * self.num_segments}"
            )
        seg = self.sig_bits // self.num_segments
        if seg & (seg - 1):
            # H3 XORs values < seg_bits; XOR is only closed under a
            # power-of-two bound, so a non-pow2 segment would hash past it.
            raise ValueError(
                f"seg_bits={seg} (sig_bits/num_segments) must be a power "
                f"of two for H3 hashing to stay in-segment"
            )

    @property
    def seg_bits(self) -> int:
        return self.sig_bits // self.num_segments

    @property
    def num_words(self) -> int:
        return self.sig_bits // 32

    @property
    def words_per_seg(self) -> int:
        return self.seg_bits // 32

    @property
    def num_byte_slices(self) -> int:
        return (self.addr_bits + 7) // 8

    @property
    def h3_matrix(self) -> np.ndarray:
        """(num_segments, addr_bits) uint32 H3 matrix, values in
        [0, seg_bits)."""
        return _h3_matrix(self)

    @property
    def h3_tables(self) -> np.ndarray:
        """(num_byte_slices, 256, num_segments) uint32 byte-sliced tables."""
        return _h3_tables(self)


@functools.lru_cache(maxsize=None)
def _h3_matrix(spec: SignatureSpec) -> np.ndarray:
    """The reference's exact numpy draw, so both packages share the matrix."""
    rng = np.random.default_rng(spec.seed)
    q = rng.integers(
        0, spec.seg_bits, size=(spec.num_segments, spec.addr_bits)
    ).astype(np.uint32)
    q.setflags(write=False)
    return q


@functools.lru_cache(maxsize=None)
def _h3_tables(spec: SignatureSpec) -> np.ndarray:
    q = _h3_matrix(spec)
    tabs = np.zeros((spec.num_byte_slices, 256, spec.num_segments), np.uint32)
    byte_vals = np.arange(256, dtype=np.uint32)
    for k in range(spec.num_byte_slices):
        for j in range(min(8, spec.addr_bits - 8 * k)):
            bit_set = ((byte_vals >> j) & 1).astype(bool)
            tabs[k] ^= np.where(bit_set[:, None], q[None, :, 8 * k + j], 0)
    tabs.setflags(write=False)
    return tabs


@functools.lru_cache(maxsize=None)
def _h3_tables_global(spec: SignatureSpec) -> np.ndarray:
    """Byte tables with the segment offsets OR-ed into slice 0: hash values
    are < seg_bits (a power of two), so the offset bits survive the XORs
    and the lookups emit global positions directly."""
    tabs = _h3_tables(spec).copy()
    offs = (np.arange(spec.num_segments, dtype=np.uint32)
            * np.uint32(spec.seg_bits))
    tabs[0] |= offs[None, :]
    tabs.setflags(write=False)
    return tabs


@functools.lru_cache(maxsize=None)
def tables_tensor(spec: SignatureSpec, device: torch.device) -> torch.Tensor:
    """The offset-folded tables as an int32 tensor on ``device`` (cached per
    spec and device; read-only by convention)."""
    arr = np.ascontiguousarray(_h3_tables_global(spec)).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


@functools.lru_cache(maxsize=None)
def h3_matrix_tensor(spec: SignatureSpec, device: torch.device) -> torch.Tensor:
    """The (num_segments, addr_bits) H3 matrix as an int32 tensor on
    ``device`` (the seed xor-fold's operand; cached per spec and device,
    read-only by convention)."""
    arr = np.ascontiguousarray(_h3_matrix(spec)).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


@functools.lru_cache(maxsize=None)
def h3_columns(spec: SignatureSpec) -> np.ndarray:
    """(num_segments, log2 seg_bits) uint32 column masks of the H3 matrix:
    bit ``j`` of ``C[m][k]`` is bit ``k`` of ``q[m][j]``, so bit ``k`` of
    segment ``m``'s hash of ``a`` is the parity of ``a & C[m][k]``
    (read-only, cached per spec).  Addresses are 32 bits, so rows of
    ``q`` past bit 31 (``addr_bits > 32``) meet no set bit and are left
    out."""
    q = _h3_matrix(spec)[:, :32].astype(np.uint64)
    log_seg = spec.seg_bits.bit_length() - 1
    k = np.arange(log_seg, dtype=np.uint64)
    j = np.arange(q.shape[1], dtype=np.uint64)
    bits = (q[:, None, :] >> k[None, :, None]) & np.uint64(1)   # (M, log, AB)
    cols = (bits << j[None, None, :]).sum(-1).astype(np.uint32)
    cols.setflags(write=False)
    return cols


@functools.lru_cache(maxsize=None)
def packed_tables(spec: SignatureSpec) -> np.ndarray:
    """(num_byte_slices, 256, E) uint64 packed byte tables: word ``e`` of
    entry ``(k, v)`` holds, for the ``P = 64 // log2(seg_bits)`` segments
    ``m = e * P + j < num_segments``, segment ``m``'s hash of byte value
    ``v`` in byte slice ``k`` at bits ``[j * log, (j + 1) * log)``; ``E =
    ceil(num_segments / P)`` (1 for the paper's 4 x 9 bits: 8 KB).  XORing
    an address's entries hashes P segments at once (read-only, cached per
    spec)."""
    tabs = _h3_tables(spec).astype(np.uint64)                 # (S, 256, M)
    log_seg = spec.seg_bits.bit_length() - 1
    per = 64 // log_seg
    out = np.zeros((tabs.shape[0], 256, -(-spec.num_segments // per)), np.uint64)
    for m in range(spec.num_segments):
        out[:, :, m // per] |= tabs[:, :, m] << np.uint64((m % per) * log_seg)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def packed_tables_tensor(spec: SignatureSpec, device: torch.device) -> torch.Tensor:
    """:func:`packed_tables` as an int64 tensor on ``device`` (the same
    bits; cached per spec and device, read-only by convention)."""
    arr = np.ascontiguousarray(packed_tables(spec)).view(np.int64)
    return torch.from_numpy(arr.copy()).to(device)


@functools.lru_cache(maxsize=None)
def default_spec() -> SignatureSpec:
    """The paper-default spec as a shared singleton."""
    return SignatureSpec()


# ---------------------------------------------------------------------------
# 32-bit word helpers (int32 storage of uint32 bits)
# ---------------------------------------------------------------------------


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same 32 bits."""
    x = x & U32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int64 holding its low 32 bits unsigned."""
    return x.to(torch.int64) & U32


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """(..., n) bool -> (..., ceil(n/32)) int32 words, little-endian bit
    order (bit b of word w is element 32w + b); pad bits are zero.

    Eight bits become one byte by a dot product with the byte's bit
    weights (exact in float32: integers <= 255), and four bytes are read as
    one word — the same word on the little-endian hosts and GPUs torch runs
    on."""
    n = bits.shape[-1]
    pad = (-n) % 32
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    b = bits.reshape(*bits.shape[:-1], -1, 8).to(torch.float32)
    return (b @ _byte_weights(bits.device)).to(torch.uint8).view(torch.int32)


@functools.lru_cache(maxsize=None)
def _byte_weights(device: torch.device) -> torch.Tensor:
    """(8,) float32 bit weights of a byte, made once per device: a fresh
    host-to-device copy per call would stall the host behind the queue."""
    return (2.0 ** torch.arange(8, dtype=torch.float32)).to(device)


def unpack_words(words: torch.Tensor, nbits: int) -> torch.Tensor:
    """(..., nw) int32 -> (..., nbits) bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :nbits].bool()


@functools.lru_cache(maxsize=None)
def _pop8(device: torch.device) -> torch.Tensor:
    v = np.arange(256, dtype=np.uint8)
    counts = np.unpackbits(v[:, None], axis=1).sum(1).astype(np.int64)
    return torch.from_numpy(counts).to(device)


def popcount_per_word(words: torch.Tensor) -> torch.Tensor:
    """Set-bit count of each int32 word (int64, same shape) via a byte
    lookup table — exact for all 32 bits, sign bit included."""
    w = words.contiguous()
    by = w.view(torch.uint8).reshape(*w.shape, 4).to(torch.int64)
    return _pop8(w.device)[by].sum(-1)


# ---------------------------------------------------------------------------
# Signature registers
# ---------------------------------------------------------------------------


def empty_signature(spec: SignatureSpec, device) -> torch.Tensor:
    """All-zero signature register, packed as (num_words,) int32."""
    return torch.zeros((spec.num_words,), dtype=torch.int32, device=device)


def empty_bank(spec: SignatureSpec, num_registers: int, device) -> torch.Tensor:
    """Bank of registers (the CPUWriteSet uses 16)."""
    return torch.zeros((num_registers, spec.num_words), dtype=torch.int32,
                       device=device)


def hash_with_tables(addrs: torch.Tensor, tabs: torch.Tensor) -> torch.Tensor:
    """Byte-sliced lookup: (N,) addresses (their low 32 bits) x (S, 256, M)
    offset-folded int32 tables -> (N, M) int32 global positions.  The plain
    PyTorch version of the ``h3_hash`` kernel."""
    a = as_u32(addrs.reshape(-1))
    h = tabs[0][a & 0xFF]
    for k in range(1, tabs.shape[0]):
        h = h ^ tabs[k][(a >> (8 * k)) & 0xFF]
    return h


def to_addr_i32(addrs: torch.Tensor) -> torch.Tensor:
    """Flatten an address batch to the int32 bit pattern of its low 32
    bits (the kernels' address type)."""
    a = addrs.reshape(-1)
    if a.dtype == torch.int32:
        return a.contiguous()
    return u32_to_i32(as_u32(a))


def hash_positions(spec: SignatureSpec, addrs: torch.Tensor) -> torch.Tensor:
    """Global bit positions (N, num_segments) int32 in [0, sig_bits) for each
    address; the ``h3_hash`` kernel on CUDA, :func:`hash_with_tables` on
    the CPU."""
    # imported here: the kernel module itself imports this one
    from repro_torch.kernels.bloom.bloom import h3_hash

    return h3_hash(spec, to_addr_i32(addrs))


def hash_positions_xorfold(spec: SignatureSpec,
                           addrs: torch.Tensor) -> torch.Tensor:
    """Per-bit xor-fold H3 (the reference's seed implementation): the plain
    hash of the seed one-hot kernels (``bloom_insert_onehot`` /
    ``bloom_query_onehot``) and the oracle of the byte-sliced path."""
    a = as_u32(addrs.reshape(-1))
    q = as_u32(h3_matrix_tensor(spec, addrs.device))
    h = torch.zeros((a.shape[0], spec.num_segments), dtype=torch.int64,
                    device=addrs.device)
    for j in range(spec.addr_bits):
        bit = ((a >> j) & 1).bool()
        h = h ^ torch.where(bit[:, None], q[None, :, j], 0)
    offs = torch.arange(spec.num_segments, device=addrs.device) * spec.seg_bits
    return (h + offs[None, :]).to(torch.int32)


def hash_positions_parity(spec: SignatureSpec,
                          addrs: torch.Tensor) -> torch.Tensor:
    """H3 in parity form (the arithmetic of the ``bloom_query`` and
    ``bloom_query_onehot`` kernels): bit ``k`` of segment ``m``'s hash is
    the parity of ``a & C[m][k]`` (:func:`h3_columns`) -> (N, num_segments)
    int32 global positions, equal to :func:`hash_with_tables` and
    :func:`hash_positions_xorfold`."""
    a = as_u32(addrs.reshape(-1))
    cols = torch.from_numpy(h3_columns(spec).astype(np.int64)).to(addrs.device)
    x = a[:, None, None] & cols[None]                        # (N, M, log)
    for shift in (16, 8, 4, 2, 1):
        x = x ^ (x >> shift)
    weights = 2 ** torch.arange(cols.shape[1], device=addrs.device)
    h = ((x & 1) * weights).sum(-1)
    offs = torch.arange(spec.num_segments, device=addrs.device) * spec.seg_bits
    return (h + offs[None, :]).to(torch.int32)


def hash_positions_packed(spec: SignatureSpec, addrs: torch.Tensor) -> torch.Tensor:
    """H3 through the packed byte tables (the arithmetic of the ``h3_hash``
    and ``bloom_detect_conflicts`` kernels): XOR the address's
    :func:`packed_tables` entries, then cut each segment's field out of its
    word and add the segment's offset -> (N, num_segments) int32 global
    positions, equal to :func:`hash_with_tables`."""
    a = as_u32(addrs.reshape(-1))
    ptab = packed_tables_tensor(spec, addrs.device)          # (S, 256, E)
    h = ptab[0][a & 0xFF]                                     # (N, E)
    for k in range(1, ptab.shape[0]):
        h = h ^ ptab[k][(a >> (8 * k)) & 0xFF]
    log_seg = spec.seg_bits.bit_length() - 1
    m = torch.arange(spec.num_segments, device=addrs.device)
    per = 64 // log_seg
    field = (h[:, m // per] >> ((m % per) * log_seg)) & (spec.seg_bits - 1)
    return u32_to_i32(field + m * spec.seg_bits)


def pack_bits(spec: SignatureSpec, bits: torch.Tensor) -> torch.Tensor:
    """(sig_bits,) bool -> (num_words,) int32 (little-endian bit order)."""
    return pack_words(bits.reshape(spec.sig_bits))


def unpack_bits(spec: SignatureSpec, words: torch.Tensor) -> torch.Tensor:
    """(..., num_words) int32 -> (..., sig_bits) bool."""
    return unpack_words(words, spec.sig_bits)


def insert(spec: SignatureSpec, sig: torch.Tensor, addrs: torch.Tensor,
           mask: torch.Tensor | None = None) -> torch.Tensor:
    """Insert a batch of addresses into a signature (``mask`` disables
    individual inserts)."""
    pos = hash_positions(spec, addrs).to(torch.int64)
    if mask is not None:
        pos = torch.where(mask.reshape(-1, 1), pos, spec.sig_bits)
    staged = torch.zeros((spec.sig_bits + 1,), dtype=torch.bool,
                         device=sig.device)
    staged[pos.reshape(-1)] = True
    return sig | pack_bits(spec, staged[: spec.sig_bits])


def insert_bank_round_robin(spec: SignatureSpec, bank: torch.Tensor,
                            addrs: torch.Tensor, counter,
                            mask: torch.Tensor | None = None):
    """CPUWriteSet-style insertion: valid addresses round-robin over the
    bank's registers.  Returns (new_bank, new_counter)."""
    num_regs = bank.shape[0]
    addrs = addrs.reshape(-1)
    dev = bank.device
    counter = torch.as_tensor(counter, dtype=torch.int64, device=dev)
    if mask is None:
        mask = torch.ones(addrs.shape, dtype=torch.bool, device=dev)
    m = mask.reshape(-1).to(torch.int64)
    offsets = torch.cumsum(m, 0) - m
    reg_ids = (counter + offsets) % num_regs
    pos = hash_positions(spec, addrs).to(torch.int64)
    pos = torch.where(m.bool()[:, None], pos, spec.sig_bits)
    stride = spec.sig_bits + 1
    flat = reg_ids[:, None] * stride + pos
    staged = torch.zeros((num_regs * stride,), dtype=torch.bool, device=dev)
    staged[flat.reshape(-1)] = True
    staged = staged.reshape(num_regs, stride)[:, : spec.sig_bits]
    return bank | pack_words(staged), (counter + m.sum()).to(torch.int32)


def query(spec: SignatureSpec, sig: torch.Tensor,
          addrs: torch.Tensor) -> torch.Tensor:
    """Membership test for a batch of addresses -> (N,) bool (no false
    negatives; real H3 false positives)."""
    pos = hash_positions(spec, addrs).to(torch.int64)
    bits = unpack_bits(spec, sig)
    return bits[pos].all(-1)


def intersect(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & b


def intersect_nonempty(spec: SignatureSpec, a: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """Paper §5.3 prefilter: True iff every segment of ``a & b`` has a set
    bit (False => the address sets are provably disjoint)."""
    inter = (a & b).reshape(spec.num_segments, spec.words_per_seg)
    return (inter != 0).any(1).all()


def bank_intersect_nonempty(spec: SignatureSpec, bank: torch.Tensor,
                            sig: torch.Tensor) -> torch.Tensor:
    """Prefilter a signature against every register of a bank."""
    inter = (bank & sig[None, :]).reshape(bank.shape[0], spec.num_segments,
                                          spec.words_per_seg)
    return (inter != 0).any(2).all(1).any()


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Number of set bits in a packed signature (any shape, summed)."""
    return popcount_per_word(words).sum()


def saturation(spec: SignatureSpec, sig: torch.Tensor) -> torch.Tensor:
    """Fraction of bits set (Bloom-filter fill factor)."""
    return popcount(sig) / spec.sig_bits


def expected_membership_fp_rate(spec: SignatureSpec, n_inserted: int) -> float:
    """Theoretical membership false-positive rate after ``n_inserted``
    distinct addresses."""
    fill = 1.0 - (1.0 - 1.0 / spec.seg_bits) ** n_inserted
    return float(fill**spec.num_segments)
