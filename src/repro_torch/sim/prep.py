"""Trace -> device tensors + the packed bitmap / signature primitives of the
simulator (PyTorch port of :mod:`repro.sim.prep`).

**Packed word layout.**  Every per-line bitmap the simulator carries
(``present``, ``dirty``, ``cpuws``, ``conc``, ``read_bm``, the per-kernel
``pre_writes``) is ``ceil(num_lines / 32)`` int32 words holding the
reference's uint32 bits: bit ``b`` of word ``w`` is line ``32 * w + b``.
Bloom images are ``sig_bits / 32`` words with the same convention.  Pad
bits past ``num_lines`` are **always zero**; every primitive preserves
that invariant (negation only appears as ``x & ~y`` against a clean
bitmap).

**Lanes.**  The engines carry a leading lane axis on every tensor (the
reference's ``vmap`` written out), so the primitives take ``(L, ...)``
tensors; the bitmap helpers accept any leading shape.

**Kernels.**  The Bloom-signature primitives of the LazyPIM step run on
the CUDA kernels of :mod:`repro_torch.kernels.bloom.bloom` (their plain
PyTorch versions on the CPU):

* ``sig_bits_from_ids``     — ``bloom_insert`` over an id list
* ``sig_bits_pair_from_ids`` — ``bloom_insert`` over two id lists at once
                              (the window's read and write images)
* ``sig_bits_from_bitmap``  — ``bloom_insert`` over a packed bitmap
* ``bank_bits_from_bitmap`` — ``bloom_insert`` in bank mode (register =
                              line % 16), the CPUWriteSet bank
* ``bank_pair_from_bitmaps`` — ``bloom_insert`` in bank mode on two bitmaps
                              at once (the window's ``cpuws`` and ``conc``)
* ``conflict_any``          — ``bloom_intersect`` of the bank with the
                              read image, any register
* ``conflict_any_pair``     — ``bloom_intersect``'s pair-and-any form: both
                              banks of a window (``cpuws`` and ``conc``)
                              against the read image, one launch
* ``members``               — ``bloom_query``: packed per-line membership
* ``members_pair``          — ``bloom_query`` on two bitmaps at once (one
                              lookup of each line against the image)
* ``prepare`` / ``pad_trace`` / ``dummy_trace`` hash the line table with
  ``h3_hash``.

``line_sig_hits`` / ``members_from_hits`` / ``conflict_from_hits`` are the
reference's fused gather forms, kept as plain PyTorch for parity tests;
``conflict_from_hits`` is bit-exact with ``conflict_any`` of
``bank_bits_from_bitmap`` (the unfused form the port's step computes, its
two banks from one ``bank_pair_from_bitmaps`` and both checks from one
``conflict_any_pair``).

The bitmap primitives the five baselines use (``scatter_set``,
``gather_hits``, ``cpu_cache_step``) stay plain PyTorch on the card, as
XLA fused them in the reference.

**Seed family.**  The ``*_bool`` primitives are the reference's boolean
seed twins of the packed ones, for ``repro_torch.core._boolref``; on the
card their Bloom images and membership masks run the seed one-hot kernels
of :mod:`repro_torch.kernels.bloom.onehot`:

* ``sig_bits_from_ids_bool`` / ``sig_bits_pair_from_ids_bool`` /
  ``sig_bits_from_bitmap_bool`` — ``bloom_insert_onehot`` (the pair form
  one launch for two lists), its packed words unpacked at the boundary
* ``members_bool`` / ``ids_member_bool`` — ``bloom_query_onehot``
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.signatures import (
    SignatureSpec,
    default_spec,
    pack_words,
    popcount_per_word,
    u32_to_i32,
    unpack_words,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.bloom import bloom as K
from repro_torch.kernels.bloom.onehot import bloom_insert_onehot, bloom_query_onehot
from repro_torch.sim.costmodel import LINE_BYTES, HWParams
from repro_torch.sim.trace import WindowTrace

CPUWS_REGS = 16  # CPUWriteSet bank registers (paper §5.7)

# Multiplicative-hash constants of the per-(line, window) thinning hashes.
KNUTH_MULT = 2654435761   # 2**32 / golden ratio (Knuth §6.4)
KNUTH_STEP = 40503        # Knuth's 16-bit multiplicative constant
XXH_PRIME2 = 2246822519   # xxHash32 PRIME32_2
XXH_PRIME5 = 374761393    # xxHash32 PRIME32_5

ALL_ONES = -1  # an int32 word with all 32 bits set


def line_window_u01(num_lines: int, window_idx: int, mult: int, step: int,
                    device) -> torch.Tensor:
    """Deterministic per-(line, window) uniform in [0, 1): the uint32
    multiplicative hash ``line * mult + window * step`` (wrapping), top 16
    bits scaled.  (num_lines,) float32."""
    h = torch.arange(num_lines, dtype=torch.int64, device=device) * mult
    h = (h + ((int(window_idx) * step) & 0xFFFFFFFF)) & 0xFFFFFFFF
    return ((h >> 16) & 0xFFFF).to(torch.float32) / 65536.0


# Static metadata vs tensor fields of TraceTensors (the reference's pytree
# split; engine.stack_traces stacks the data fields along the lane axis).
TRACE_META_FIELDS = ("name", "threads", "num_lines", "num_windows",
                     "num_kernels", "spec")
TRACE_DATA_FIELDS = ("line_pos", "line_reg", "pim_reads", "pim_writes",
                     "cpu_reads", "cpu_writes", "pim_r_valid", "pim_w_valid",
                     "cpu_r_valid", "cpu_w_valid", "kernel_id", "kernel_start",
                     "kernel_end", "pre_writes", "pre_writes_words",
                     "pim_instr", "cpu_instr", "cpu_priv", "pim_uniq_r",
                     "pim_uniq_w", "pim_uniq", "cpu_priv_miss_rate",
                     "cpu_reuse", "window_valid")


@dataclasses.dataclass(frozen=True)
class TraceTensors:
    """Device-resident, fixed-shape view of one WindowTrace.  The engines
    stack traces along a leading lane axis (``engine.stack_traces``); then
    every data field carries that axis first."""

    name: str
    threads: int
    num_lines: int
    num_windows: int
    num_kernels: int
    spec: SignatureSpec

    line_pos: torch.Tensor      # (num_lines, M) int32 global bit positions
    line_reg: torch.Tensor      # (num_lines,) int32 CPUWriteSet register id
    pim_reads: torch.Tensor     # (W, AR) int32, -1 = empty slot
    pim_writes: torch.Tensor    # (W, AW) int32
    cpu_reads: torch.Tensor     # (W, BR) int32
    cpu_writes: torch.Tensor    # (W, BW) int32
    pim_r_valid: torch.Tensor   # (W, AR) bool
    pim_w_valid: torch.Tensor   # (W, AW) bool
    cpu_r_valid: torch.Tensor   # (W, BR) bool
    cpu_w_valid: torch.Tensor   # (W, BW) bool
    kernel_id: torch.Tensor     # (W,) int32
    kernel_start: torch.Tensor  # (W,) bool
    kernel_end: torch.Tensor    # (W,) bool
    pre_writes: torch.Tensor    # (K, num_lines) bool
    pre_writes_words: torch.Tensor  # (K, ceil(num_lines/32)) int32
    pim_instr: torch.Tensor     # (W,) f32
    cpu_instr: torch.Tensor     # (W,) f32
    cpu_priv: torch.Tensor      # (W,) f32
    cpu_priv_miss_rate: torch.Tensor  # () f32
    cpu_reuse: torch.Tensor           # () f32
    pim_uniq_r: torch.Tensor    # (W,) f32
    pim_uniq_w: torch.Tensor    # (W,) f32
    pim_uniq: torch.Tensor      # (W,) f32 (reads ∪ writes)
    # False marks windows appended by pad_trace: every mechanism step
    # passes its carry through unchanged there.
    window_valid: torch.Tensor  # (W,) bool

    @property
    def sig_bits(self) -> int:
        return self.spec.sig_bits

    @property
    def num_segments(self) -> int:
        return self.spec.num_segments

    @property
    def num_line_words(self) -> int:
        return (self.num_lines + 31) // 32

    @property
    def sig_words(self) -> int:
        return self.spec.num_words

    @property
    def device(self) -> torch.device:
        return self.window_valid.device


# ---------------------------------------------------------------------------
# Packed bitmap core
# ---------------------------------------------------------------------------


def packed_words(nbits: int) -> int:
    return (nbits + 31) // 32


pack_bitmap = pack_words
unpack_bitmap = unpack_words


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Set-bit count of each packed bitmap row (sum over the last axis),
    int64."""
    return popcount_per_word(words).sum(-1)


def scatter_set(words: torch.Tensor, ids: torch.Tensor,
                valid: torch.Tensor | None, nbits: int) -> torch.Tensor:
    """OR the valid line ids (..., A) into packed bitmaps (..., nw).

    Sort each row, keep the first of each duplicate run, then scatter-add
    single-bit masks: after the dedupe every update targets a distinct bit,
    so the add is exactly an OR.  Negative ids (the -1 sentinel) and ids
    >= ``nbits`` are dropped, never wrapped."""
    p = ids.to(torch.int64)
    if valid is not None:
        p = torch.where(valid, p, nbits)
    p, _ = torch.sort(p, dim=-1)
    fresh = torch.ones_like(p, dtype=torch.bool)
    fresh[..., 1:] = p[..., 1:] != p[..., :-1]
    keep = fresh & (p >= 0) & (p < nbits)
    nw = words.shape[-1]
    word = torch.where(keep, p >> 5, nw)
    mask = torch.where(keep, torch.ones_like(p) << (p & 31), 0)
    delta = torch.zeros((*words.shape[:-1], nw + 1), dtype=torch.int64,
                        device=words.device)
    delta.scatter_add_(-1, word, mask)
    return words | u32_to_i32(delta[..., :nw])


def gather_hits(words: torch.Tensor, ids: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Per-slot hit flags: valid & line present (packed lookup)."""
    idx = ids.to(torch.int64).clamp(0, words.shape[-1] * 32 - 1)
    w = words.gather(-1, idx >> 5)
    return valid & (((w >> (idx & 31)) & 1) != 0)


# ---------------------------------------------------------------------------
# Signature primitives (lane-batched; CUDA kernels on the card)
# ---------------------------------------------------------------------------


def sig_bits_from_ids(tt: TraceTensors, ids: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Packed Bloom images (L, sig_words) of the valid line ids (L, A)."""
    return K.bloom_insert(tt.spec, ids=ids.contiguous(),
                          valid=valid.contiguous())[:, 0]


def sig_bits_pair_from_ids(tt: TraceTensors, ids_a: torch.Tensor,
                           valid_a: torch.Tensor, ids_b: torch.Tensor,
                           valid_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sig_bits_from_ids(tt, ids_a, valid_a), sig_bits_from_ids(tt, ids_b,
    valid_b))`` from one ``bloom_insert`` launch."""
    a, b = K.bloom_insert(tt.spec, ids=ids_a.contiguous(), valid=valid_a.contiguous(),
                          ids_b=ids_b.contiguous(), valid_b=valid_b.contiguous())
    return a[:, 0], b[:, 0]


def sig_bits_from_bitmap(tt: TraceTensors, words: torch.Tensor) -> torch.Tensor:
    """Packed Bloom images (L, sig_words) of all lines set in packed
    bitmaps (L, num_line_words)."""
    return K.bloom_insert(tt.spec, bitmap=words.contiguous(),
                          num_lines=tt.num_lines)[:, 0]


def bank_bits_from_bitmap(tt: TraceTensors, words: torch.Tensor,
                          num_regs: int = CPUWS_REGS) -> torch.Tensor:
    """Packed CPUWriteSet banks (L, num_regs, sig_words) from packed
    dirty-line bitmaps (L, num_line_words); register = line id % num_regs,
    the deterministic equivalent of the paper's round-robin pointer for
    set-valued insertion."""
    return K.bloom_insert(tt.spec, bitmap=words.contiguous(), num_lines=tt.num_lines,
                          num_regs=num_regs)


def bank_pair_from_bitmaps(tt: TraceTensors, words_a: torch.Tensor,
                           words_b: torch.Tensor, num_regs: int = CPUWS_REGS
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(bank_bits_from_bitmap(tt, words_a, num_regs),
    bank_bits_from_bitmap(tt, words_b, num_regs))`` from one
    ``bloom_insert`` launch."""
    return K.bloom_insert(tt.spec, bitmap=words_a.contiguous(), num_lines=tt.num_lines,
                          num_regs=num_regs, bitmap_b=words_b.contiguous())


def conflict_any(tt: TraceTensors, read_words: torch.Tensor,
                 bank_words: torch.Tensor) -> torch.Tensor:
    """Paper §5.3/§5.5 conflict prefilter per lane: True iff the read image
    (L, sig_words) intersects ANY register of the bank (L, R, sig_words)
    with every segment non-empty."""
    lanes, regs, nw = bank_words.shape
    hit = K.bloom_intersect(bank_words.reshape(lanes * regs, nw),
                            read_words.contiguous(), tt.num_segments)
    return hit.reshape(lanes, regs).any(1)


def conflict_any_pair(tt: TraceTensors, read_words: torch.Tensor, bank_a: torch.Tensor,
                      bank_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(conflict_any(tt, read_words, bank_a), conflict_any(tt, read_words,
    bank_b))`` from one ``bloom_intersect`` launch: the banks (L, R,
    sig_words) each, the per-lane any over registers inside the kernel."""
    lanes, regs, nw = bank_a.shape
    hit = K.bloom_intersect(bank_a.reshape(lanes * regs, nw), read_words.contiguous(),
                            tt.num_segments, a_b=bank_b.reshape(lanes * regs, nw))
    return hit[0], hit[1]


def members(tt: TraceTensors, words: torch.Tensor,
            sig_words: torch.Tensor) -> torch.Tensor:
    """Packed per-line membership masks (L, num_line_words) of the lines set
    in ``words`` against the images ``sig_words`` (L, sig_words), with the
    signature's real false positives."""
    return K.bloom_query(tt.spec, sig_words.contiguous(), words.contiguous(),
                         tt.num_lines)


def members_pair(tt: TraceTensors, words_a: torch.Tensor, words_b: torch.Tensor,
                 sig_words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(members(tt, words_a, sig_words), members(tt, words_b, sig_words))``
    from one ``bloom_query`` launch: a line's membership depends only on the
    image, so each line set in either bitmap is looked up once (the
    reference's ``line_sig_hits`` + two ``members_from_hits``)."""
    return K.bloom_query(tt.spec, sig_words.contiguous(), words_a.contiguous(),
                         tt.num_lines, words_b=words_b.contiguous())


def line_sig_hits(tt: TraceTensors, sig_words: torch.Tensor) -> torch.Tensor:
    """Per-(line, segment) signature bit lookups (num_lines, M) bool for one
    (sig_words,) image — the reference's fused gather (plain PyTorch)."""
    pos = tt.line_pos.to(torch.int64)
    w = sig_words[pos >> 5]
    return ((w >> (pos & 31)) & 1) != 0


def members_from_hits(words: torch.Tensor, hits: torch.Tensor) -> torch.Tensor:
    """``members`` given a precomputed :func:`line_sig_hits` gather."""
    return words & pack_bitmap(hits.all(1))


def conflict_from_hits(tt: TraceTensors, words: torch.Tensor,
                       hits: torch.Tensor,
                       num_regs: int = CPUWS_REGS) -> torch.Tensor:
    """``conflict_any(sig, bank_bits_from_bitmap(words))`` as a gather plus a
    mod-``num_regs`` segment reduction (the reference's fused form)."""
    n = tt.num_lines
    masked = hits & unpack_bitmap(words, n)[:, None]
    pad = (-n) % num_regs
    masked = torch.nn.functional.pad(masked, (0, 0, 0, pad))
    seg_any = masked.reshape(-1, num_regs, tt.num_segments).any(0)
    return seg_any.all(1).any()


# ---------------------------------------------------------------------------
# CPU cache bitmap evolution (packed, lane-batched)
# ---------------------------------------------------------------------------


def evict_to_cap(present: torch.Tensor, dirty: torch.Tensor, window_idx: int,
                 cap: torch.Tensor, nbits: int):
    """Capacity model: thin each lane's presence bitmap down to ~cap lines
    with the deterministic per-(line, window) hash; evicted dirty lines are
    written back (returned as a float32 count).  No-op under cap."""
    count = popcount_words(present)
    over = count > cap
    keep_prob = (cap / torch.clamp(count, min=1)).clamp(0.0, 1.0)
    u = line_window_u01(nbits, window_idx, KNUTH_MULT, KNUTH_STEP, present.device)
    over_mask = torch.where(over, ALL_ONES, 0).to(torch.int32)[:, None]
    drop = present & pack_bitmap(u[None, :] > keep_prob[:, None]) & over_mask
    wb_lines = popcount_words(dirty & drop).to(torch.float32)
    return present & ~drop, dirty & ~drop, wb_lines


@dataclasses.dataclass
class CpuStepOut:
    present: torch.Tensor
    dirty: torch.Tensor
    hits: torch.Tensor        # (L,) f32
    misses: torch.Tensor      # (L,) f32
    wb_lines: torch.Tensor    # capacity writebacks, f32
    mem_ns: torch.Tensor      # CPU-side memory latency for this window
    fill_bytes: torch.Tensor  # off-chip fill traffic (miss fills)


def cpu_cache_step(tt: TraceTensors, hw: HWParams, present: torch.Tensor,
                   dirty: torch.Tensor, w: int, *, cacheable: bool = True,
                   cap_lines=None) -> CpuStepOut:
    """One window of CPU-thread accesses to the PIM data region, on packed
    word bitmaps, for every lane of a stacked trace.  ``cacheable=False``
    models NC: every access goes to DRAM and the bitmaps stay empty."""
    cr, crv = tt.cpu_reads[:, w], tt.cpu_r_valid[:, w]
    cw, cwv = tt.cpu_writes[:, w], tt.cpu_w_valid[:, w]
    n_acc = (crv.sum(1) + cwv.sum(1)).to(torch.float32)
    reuse = tt.cpu_reuse
    miss_ns = hw.offchip_mem_ns / hw.cpu_mlp

    if not cacheable:
        n_dyn = n_acc * reuse
        mem_ns = n_dyn * miss_ns / hw.cpu_cores
        fill = n_dyn * hw.nc_bytes
        zero = torch.zeros_like(n_acc)
        return CpuStepOut(present, dirty, zero, n_dyn, zero, mem_ns, fill)

    r_hit = gather_hits(present, cr, crv)
    w_hit = gather_hits(present, cw, cwv)
    misses = ((crv & ~r_hit).sum(1) + (cwv & ~w_hit).sum(1)).to(torch.float32)
    hits = (r_hit.sum(1) + w_hit.sum(1)).to(torch.float32)
    present = scatter_set(present, cr, crv, tt.num_lines)
    present = scatter_set(present, cw, cwv, tt.num_lines)
    dirty = scatter_set(dirty, cw, cwv, tt.num_lines)
    cap = cap_lines if cap_lines is not None else hw.thread_cache_cap
    present, dirty, wb = evict_to_cap(present, dirty, w, cap, tt.num_lines)
    repeats_ns = n_acc * (reuse - 1.0) * hw.l1_hit_ns
    mem_ns = (hits * hw.l2_hit_ns + misses * miss_ns + repeats_ns) / hw.cpu_cores
    fill = (misses + wb) * LINE_BYTES
    return CpuStepOut(present, dirty, hits, misses, wb, mem_ns, fill)


# ---------------------------------------------------------------------------
# Boolean seed reference path (*_bool): the same math on (L, num_lines)
# bool bitmaps and (L, sig_bits) bool Bloom images, for the seed engine of
# ``repro_torch.core._boolref`` and the differential tests.  The Bloom
# image and membership primitives run the seed one-hot kernels on the card
# (``bloom_insert_onehot`` / ``bloom_query_onehot``), hashing line ids with
# the xor-fold H3 in the kernel (the same positions ``line_pos`` holds);
# the CPUWriteSet bank, the conflict prefilter and the cache-bitmap steps
# stay plain PyTorch.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _line_ids(num_lines: int, device: torch.device) -> torch.Tensor:
    """(1, num_lines) int32 line ids 0..num_lines-1 (cached per device)."""
    return torch.arange(num_lines, dtype=torch.int32, device=device)[None, :]


def _lane_ids(tt: TraceTensors, lanes: int) -> torch.Tensor:
    """(lanes, num_lines) int32 line ids, one row per lane."""
    ids = _line_ids(tt.num_lines, tt.device)
    return ids if lanes == 1 else ids.expand(lanes, -1).contiguous()


def _image_from_ids(tt: TraceTensors, ids: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """(L, sig_bits) bool image of the masked ids (L, N): B8 insert returns
    packed words, as the TPU kernel does, so they are unpacked here."""
    words = bloom_insert_onehot(tt.spec, None, ids.contiguous(), mask.contiguous())
    return unpack_words(words, tt.sig_bits)


def _sig_image_bool(tt: TraceTensors, bitmap: torch.Tensor) -> torch.Tensor:
    """(L, sig_bits) bool image of every line set in ``bitmap`` (L, n)."""
    return _image_from_ids(tt, _lane_ids(tt, bitmap.shape[0]), bitmap)


def _bank_image_bool(tt: TraceTensors, bitmap: torch.Tensor,
                     num_regs: int) -> torch.Tensor:
    """(L, num_regs, sig_bits) bool CPUWriteSet bank of the lines set in
    ``bitmap`` (L, n): line i goes to register ``line_reg[i]``.  Each lane's
    registers are staged ``sig_bits + 1`` wide; unset lines land in the
    extra slot, which is cut off."""
    lanes = bitmap.shape[0]
    stride = tt.sig_bits + 1
    pos = torch.where(bitmap[..., None], tt.line_pos.to(torch.int64), tt.sig_bits)
    reg = tt.line_reg.to(torch.int64)[..., None]
    base = torch.arange(lanes, dtype=torch.int64, device=bitmap.device) * num_regs
    flat = (base[:, None, None] + reg) * stride + pos
    staged = torch.zeros((lanes * num_regs * stride,), dtype=torch.bool,
                         device=bitmap.device)
    staged[flat.reshape(-1)] = True
    return staged.reshape(lanes, num_regs, stride)[..., :tt.sig_bits]


def sig_bits_from_ids_bool(tt: TraceTensors, ids: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """Bloom images (L, sig_bits) bool of the valid line ids in ``ids``
    (L, A); B8 insert on the card, unpacked at its boundary."""
    return _image_from_ids(tt, ids, valid)


def sig_bits_pair_from_ids_bool(tt: TraceTensors, ids_a: torch.Tensor,
                                valid_a: torch.Tensor, ids_b: torch.Tensor,
                                valid_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sig_bits_from_ids_bool(tt, ids_a, valid_a),
    sig_bits_from_ids_bool(tt, ids_b, valid_b))`` from one B8 insert launch."""
    a, b = bloom_insert_onehot(tt.spec, None, ids_a.contiguous(), valid_a.contiguous(),
                               addrs_b=ids_b.contiguous(), mask_b=valid_b.contiguous())
    return unpack_words(a, tt.sig_bits), unpack_words(b, tt.sig_bits)


def sig_bits_from_bitmap_bool(tt: TraceTensors,
                              bitmap: torch.Tensor) -> torch.Tensor:
    """Bloom images (L, sig_bits) bool of all lines set in ``bitmap``
    (L, n) bool; B8 insert on the card, unpacked at its boundary."""
    return _sig_image_bool(tt, bitmap)


def bank_bits_from_bitmap_bool(tt: TraceTensors, bitmap: torch.Tensor,
                               num_regs: int = CPUWS_REGS) -> torch.Tensor:
    """CPUWriteSet banks (L, num_regs, sig_bits) bool from dirty-line
    bitmaps (L, n) bool (plain PyTorch: B8 has no register axis)."""
    return _bank_image_bool(tt, bitmap, num_regs)


def conflict_any_bool(tt: TraceTensors, read_bits: torch.Tensor,
                      bank_bits: torch.Tensor) -> torch.Tensor:
    """Boolean-image conflict prefilter per lane: True iff the read image
    (L, sig_bits) meets any register of the bank (L, R, sig_bits) in every
    segment."""
    inter = bank_bits & read_bits[:, None, :]
    seg = inter.reshape(*bank_bits.shape[:2], tt.num_segments, -1)
    return seg.any(3).all(2).any(1)


def members_bool(tt: TraceTensors, bitmap: torch.Tensor,
                 bits: torch.Tensor) -> torch.Tensor:
    """Per-line signature membership (L, n) bool of the lines set in
    ``bitmap`` (L, n) against the images ``bits`` (L, sig_bits); B8 query
    hashes every line id on the card."""
    hit = bloom_query_onehot(tt.spec, bits.contiguous(),
                             _lane_ids(tt, bitmap.shape[0]))
    return bitmap & hit


def ids_member_bool(tt: TraceTensors, ids: torch.Tensor, valid: torch.Tensor,
                    bits: torch.Tensor) -> torch.Tensor:
    """Signature membership (L, A) bool of an id list (L, A) against the
    images ``bits`` (L, sig_bits); B8 query on the clipped ids."""
    clipped = ids.clamp(0, tt.num_lines - 1).contiguous()
    return valid & bloom_query_onehot(tt.spec, bits.contiguous(), clipped)


def ids_member(tt: TraceTensors, ids: torch.Tensor, valid: torch.Tensor,
               sig_words: torch.Tensor) -> torch.Tensor:
    """Signature membership of an id list against a packed image: ``ids`` /
    ``valid`` (..., A), ``sig_words`` (..., sig_words) with the same leading
    shape -> (..., A) bool.  The reference's gather over ``line_pos`` on the
    clipped ids (plain PyTorch, like :func:`line_sig_hits`)."""
    pos = tt.line_pos[ids.clamp(0, tt.num_lines - 1).to(torch.int64)].to(torch.int64)
    lead = sig_words.shape[:-1]
    w = torch.gather(sig_words, -1, (pos >> 5).reshape(*lead, -1)).reshape(pos.shape)
    return valid & (((w >> (pos & 31)) & 1) != 0).all(-1)


def scatter_set_bool(bitmap: torch.Tensor, ids: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """OR line ids (L, A) into bool bitmaps (L, n).  Invalid slots go to
    the staged extra index ``n``, which is cut off."""
    n = bitmap.shape[-1]
    idx = torch.where(valid, ids.to(torch.int64), n)
    staged = torch.nn.functional.pad(bitmap, (0, 1))
    staged.scatter_(-1, idx, True)
    return staged[..., :n]


def gather_hits_bool(bitmap: torch.Tensor, ids: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Per-slot hit flags (L, A): valid & line present."""
    idx = ids.to(torch.int64).clamp(0, bitmap.shape[-1] - 1)
    return valid & bitmap.gather(-1, idx)


def evict_to_cap_bool(present: torch.Tensor, dirty: torch.Tensor,
                      window_idx: int, cap):
    """Boolean-bitmap capacity eviction: :func:`evict_to_cap` on (L, n)
    bool bitmaps, with the same thinning hash and float32 keep rule."""
    n = present.shape[-1]
    count = present.sum(-1)
    over = count > cap
    keep_prob = (cap / torch.clamp(count, min=1)).clamp(0.0, 1.0)
    u = line_window_u01(n, window_idx, KNUTH_MULT, KNUTH_STEP, present.device)
    drop = present & (u[None, :] > keep_prob[:, None]) & over[:, None]
    wb_lines = (dirty & drop).sum(-1).to(torch.float32)
    return present & ~drop, dirty & ~drop, wb_lines


def cpu_cache_step_bool(tt: TraceTensors, hw: HWParams, present: torch.Tensor,
                        dirty: torch.Tensor, w: int, *, cacheable: bool = True,
                        cap_lines=None) -> CpuStepOut:
    """:func:`cpu_cache_step` on (L, n) bool bitmaps (seed reference)."""
    cr, crv = tt.cpu_reads[:, w], tt.cpu_r_valid[:, w]
    cw, cwv = tt.cpu_writes[:, w], tt.cpu_w_valid[:, w]
    n_acc = (crv.sum(1) + cwv.sum(1)).to(torch.float32)
    reuse = tt.cpu_reuse
    miss_ns = hw.offchip_mem_ns / hw.cpu_mlp

    if not cacheable:
        n_dyn = n_acc * reuse
        mem_ns = n_dyn * miss_ns / hw.cpu_cores
        fill = n_dyn * hw.nc_bytes
        zero = torch.zeros_like(n_acc)
        return CpuStepOut(present, dirty, zero, n_dyn, zero, mem_ns, fill)

    r_hit = gather_hits_bool(present, cr, crv)
    w_hit = gather_hits_bool(present, cw, cwv)
    misses = ((crv & ~r_hit).sum(1) + (cwv & ~w_hit).sum(1)).to(torch.float32)
    hits = (r_hit.sum(1) + w_hit.sum(1)).to(torch.float32)
    present = scatter_set_bool(present, cr, crv)
    present = scatter_set_bool(present, cw, cwv)
    dirty = scatter_set_bool(dirty, cw, cwv)
    cap = cap_lines if cap_lines is not None else hw.thread_cache_cap
    present, dirty, wb = evict_to_cap_bool(present, dirty, w, cap)
    repeats_ns = n_acc * (reuse - 1.0) * hw.l1_hit_ns
    mem_ns = (hits * hw.l2_hit_ns + misses * miss_ns + repeats_ns) / hw.cpu_cores
    fill = (misses + wb) * LINE_BYTES
    return CpuStepOut(present, dirty, hits, misses, wb, mem_ns, fill)


# ---------------------------------------------------------------------------
# Trace staging
# ---------------------------------------------------------------------------


def _uniq_count_loop(rows: torch.Tensor) -> torch.Tensor:
    """Per-row count of distinct non-negative entries, one row at a time
    (the seed implementation :func:`_uniq_count` replaced), float32."""
    out = torch.empty((rows.shape[0],), dtype=torch.float32)
    for i, row in enumerate(rows):
        out[i] = torch.unique(row[row >= 0]).numel()
    return out.to(rows.device)


def _uniq_union_count_loop(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row count of the distinct non-negative entries of two id lists,
    one row at a time (seed implementation), float32."""
    out = torch.empty((a.shape[0],), dtype=torch.float32)
    for i in range(a.shape[0]):
        both = torch.cat([a[i][a[i] >= 0], b[i][b[i] >= 0]])
        out[i] = torch.unique(both).numel()
    return out.to(a.device)


def _uniq_count(rows: torch.Tensor) -> torch.Tensor:
    """Per-row count of distinct non-negative entries, float32: the sort
    pushes the -1 padding to the front; an entry counts iff it is valid and
    differs from its left neighbour."""
    s, _ = torch.sort(rows, dim=1)
    valid = s >= 0
    first = valid.clone()
    first[:, 1:] = valid[:, 1:] & (s[:, 1:] != s[:, :-1])
    return first.sum(1).to(torch.float32)


def _line_tables(spec: SignatureSpec, start: int, stop: int, device):
    """(line_pos, line_reg) rows for line ids [start, stop): the H3 positions
    (``h3_hash`` kernel) and the CPUWriteSet register ids."""
    ids = torch.arange(start, stop, dtype=torch.int32, device=device)
    return K.h3_hash(spec, ids), ids % CPUWS_REGS


def prepare(trace: WindowTrace, spec: SignatureSpec | None = None,
            device=None) -> TraceTensors:
    """Stage a WindowTrace on ``device`` (``None`` = the CUDA card; pass
    ``"cpu"`` for the CPU) with its per-line hash table, validity masks,
    packed pre-writes and unique-line counts."""
    dev = resolve_device(device)
    spec = spec or default_spec()
    n = trace.num_lines

    def t(x, dt):
        return x.to(device=dev, dtype=dt).contiguous()

    pim_reads = t(trace.pim_reads, torch.int32)
    pim_writes = t(trace.pim_writes, torch.int32)
    cpu_reads = t(trace.cpu_reads, torch.int32)
    cpu_writes = t(trace.cpu_writes, torch.int32)
    pre_writes = t(trace.pre_writes, torch.bool)
    line_pos, line_reg = _line_tables(spec, 0, n, dev)
    return TraceTensors(
        name=trace.name, threads=trace.threads, num_lines=n,
        num_windows=trace.num_windows, num_kernels=trace.num_kernels,
        spec=spec, line_pos=line_pos, line_reg=line_reg,
        pim_reads=pim_reads, pim_writes=pim_writes,
        cpu_reads=cpu_reads, cpu_writes=cpu_writes,
        pim_r_valid=pim_reads >= 0, pim_w_valid=pim_writes >= 0,
        cpu_r_valid=cpu_reads >= 0, cpu_w_valid=cpu_writes >= 0,
        kernel_id=t(trace.kernel_id, torch.int32),
        kernel_start=t(trace.kernel_start, torch.bool),
        kernel_end=t(trace.kernel_end, torch.bool),
        pre_writes=pre_writes,
        pre_writes_words=pack_bitmap(pre_writes),
        pim_instr=t(trace.pim_instr, torch.float32),
        cpu_instr=t(trace.cpu_instr, torch.float32),
        cpu_priv=t(trace.cpu_priv_accesses, torch.float32),
        cpu_priv_miss_rate=torch.tensor(float(trace.cpu_priv_miss_rate),
                                        dtype=torch.float32, device=dev),
        cpu_reuse=torch.tensor(float(trace.cpu_reuse), dtype=torch.float32,
                               device=dev),
        pim_uniq_r=_uniq_count(pim_reads),
        pim_uniq_w=_uniq_count(pim_writes),
        pim_uniq=_uniq_count(torch.cat([pim_reads, pim_writes], 1)),
        window_valid=torch.ones((trace.num_windows,), dtype=torch.bool,
                                device=dev),
    )


def neutral_trace(tt: TraceTensors) -> TraceTensors:
    """Strip the presentation-only metadata (``name``/``threads``); results
    are finalized with the original trace's name by the caller."""
    if tt.name == "" and tt.threads == 0:
        return tt
    return dataclasses.replace(tt, name="", threads=0)


def dummy_trace(spec: SignatureSpec, *, num_lines: int, num_windows: int,
                num_kernels: int, pim_read_slots: int, pim_write_slots: int,
                cpu_read_slots: int, cpu_write_slots: int,
                device=None) -> TraceTensors:
    """An all-sentinel trace at an exact bucket geometry: no valid access
    slot, every window invalid, so every mechanism passes its carry
    straight through and the lane contributes nothing.  Its per-line tables
    are the real H3 positions, identical to what ``pad_trace`` produces."""
    dev = resolve_device(device)
    n, w, k = num_lines, num_windows, num_kernels

    def slots(width):
        return torch.full((w, width), -1, dtype=torch.int32, device=dev)

    def invalid(width):
        return torch.zeros((w, width), dtype=torch.bool, device=dev)

    def zf(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    line_pos, line_reg = _line_tables(spec, 0, n, dev)
    return TraceTensors(
        name="", threads=0, num_lines=n, num_windows=w, num_kernels=k,
        spec=spec, line_pos=line_pos, line_reg=line_reg,
        pim_reads=slots(pim_read_slots), pim_writes=slots(pim_write_slots),
        cpu_reads=slots(cpu_read_slots), cpu_writes=slots(cpu_write_slots),
        pim_r_valid=invalid(pim_read_slots),
        pim_w_valid=invalid(pim_write_slots),
        cpu_r_valid=invalid(cpu_read_slots),
        cpu_w_valid=invalid(cpu_write_slots),
        kernel_id=torch.zeros((w,), dtype=torch.int32, device=dev),
        kernel_start=torch.zeros((w,), dtype=torch.bool, device=dev),
        kernel_end=torch.zeros((w,), dtype=torch.bool, device=dev),
        pre_writes=torch.zeros((k, n), dtype=torch.bool, device=dev),
        pre_writes_words=torch.zeros((k, packed_words(n)), dtype=torch.int32,
                                     device=dev),
        pim_instr=zf(w), cpu_instr=zf(w), cpu_priv=zf(w),
        cpu_priv_miss_rate=zf(), cpu_reuse=zf(),
        pim_uniq_r=zf(w), pim_uniq_w=zf(w), pim_uniq=zf(w),
        window_valid=torch.zeros((w,), dtype=torch.bool, device=dev),
    )


def dummy_lane_triple(spec: SignatureSpec, shape: dict[str, int],
                      lazy_static: dict | None = None, device=None):
    """One (trace, hw, lazy) pad-lane triple at a bucket ``shape``: the
    all-sentinel :func:`dummy_trace`, default ``HWParams`` and a default
    lazy config carrying the group's static flags."""
    from repro_torch.core.coherence import LazyPIMConfig

    return (dummy_trace(spec, **shape, device=device), HWParams(),
            LazyPIMConfig(**(lazy_static or {})))


# ---------------------------------------------------------------------------
# Geometry-bucketed padding
# ---------------------------------------------------------------------------


def bucket_bound(n: int) -> int:
    """The smallest power of four >= n (bounds padding waste at 4x while
    keeping the bucket count low)."""
    if n < 1:
        raise ValueError(f"bucket_bound needs n >= 1, got {n}")
    b = 1
    while b < n:
        b <<= 2
    return b


def pad_trace(tt: TraceTensors, *, num_lines: int | None = None,
              num_windows: int | None = None, num_kernels: int | None = None,
              pim_read_slots: int | None = None,
              pim_write_slots: int | None = None,
              cpu_read_slots: int | None = None,
              cpu_write_slots: int | None = None) -> TraceTensors:
    """Pad a prepared trace up to a bucket geometry under explicit validity:
    padded lines never enter a bitmap or signature (no slot references
    them, pad bits stay zero), padded slots are -1 and invalid, padded
    windows are marked invalid in ``window_valid``, padded kernels have
    empty pre-write sets.  The padded rows of ``line_pos``/``line_reg`` are
    the real hash positions / register ids of those line ids."""
    n, n2 = tt.num_lines, num_lines or tt.num_lines
    w, w2 = tt.num_windows, num_windows or tt.num_windows
    k, k2 = tt.num_kernels, num_kernels or tt.num_kernels
    widths = {
        "pim_reads": pim_read_slots, "pim_writes": pim_write_slots,
        "cpu_reads": cpu_read_slots, "cpu_writes": cpu_write_slots,
    }
    for label, cur, tgt in (("num_lines", n, n2), ("num_windows", w, w2),
                            ("num_kernels", k, k2)):
        if tgt < cur:
            raise ValueError(f"cannot shrink {label}: {cur} -> {tgt}")

    F = torch.nn.functional
    fields = {f.name: getattr(tt, f.name) for f in dataclasses.fields(tt)}
    fields.update(num_lines=n2, num_windows=w2, num_kernels=k2)

    if n2 > n:
        pos, reg = _line_tables(tt.spec, n, n2, tt.device)
        fields["line_pos"] = torch.cat([tt.line_pos, pos])
        fields["line_reg"] = torch.cat([tt.line_reg, reg])

    valid_of = {"pim_reads": "pim_r_valid", "pim_writes": "pim_w_valid",
                "cpu_reads": "cpu_r_valid", "cpu_writes": "cpu_w_valid"}
    for key, width in widths.items():
        ids = fields[key]
        a, a2 = ids.shape[1], width or ids.shape[1]
        if a2 < a:
            raise ValueError(f"cannot shrink {key} slots: {a} -> {a2}")
        pad = (0, a2 - a, 0, w2 - w)
        fields[key] = F.pad(ids, pad, value=-1)
        fields[valid_of[key]] = F.pad(fields[valid_of[key]], pad)

    for key in ("kernel_id", "kernel_start", "kernel_end", "pim_instr",
                "cpu_instr", "cpu_priv", "pim_uniq_r", "pim_uniq_w",
                "pim_uniq", "window_valid"):
        fields[key] = F.pad(fields[key], (0, w2 - w))
    # Zero-padding the packed words IS packing the zero-padded bool rows:
    # the original last word's pad bits are already zero (the invariant).
    fields["pre_writes"] = F.pad(tt.pre_writes, (0, n2 - n, 0, k2 - k))
    fields["pre_writes_words"] = F.pad(
        tt.pre_writes_words,
        (0, packed_words(n2) - packed_words(n), 0, k2 - k))
    return TraceTensors(**fields)


def bucket_shapes(tts: list[TraceTensors]) -> list[tuple[list[int], dict[str, int]]]:
    """Bucket membership and padded target shapes for a fleet, keyed by
    ``(bucket_bound(num_lines), spec)``; windows, kernels and slot widths go
    to the per-bucket maxima.  Buckets appear in first-occurrence order and
    members keep input order (the reference's policy, so both packages plan
    the same buckets)."""
    groups: dict[tuple, list[int]] = {}
    for i, t in enumerate(tts):
        groups.setdefault((bucket_bound(t.num_lines), t.spec), []).append(i)
    out = []
    for (bound, _spec), idx in groups.items():
        member = [tts[i] for i in idx]
        out.append((idx, dict(
            num_lines=bound,
            num_windows=max(t.num_windows for t in member),
            num_kernels=max(t.num_kernels for t in member),
            pim_read_slots=max(t.pim_reads.shape[1] for t in member),
            pim_write_slots=max(t.pim_writes.shape[1] for t in member),
            cpu_read_slots=max(t.cpu_reads.shape[1] for t in member),
            cpu_write_slots=max(t.cpu_writes.shape[1] for t in member),
        )))
    return out


def bucket_traces(tts: list[TraceTensors]) -> list[tuple[list[int], list[TraceTensors]]]:
    """Group prepared traces into geometry buckets and pad every member to
    its bucket's shape."""
    return [(idx, [pad_trace(tts[i], **shape) for i in idx])
            for idx, shape in bucket_shapes(tts)]
