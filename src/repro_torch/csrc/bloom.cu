// Bloom-signature kernels of the LazyPIM simulator for Hopper (sm_90a).
//
// Five kernels, each the CUDA counterpart of a Pallas TPU kernel in
// src/repro/kernels/bloom/bloom.py.  Packed words are uint32 here; the
// PyTorch side stores the same bits as int32.  Every kernel launches on
// the caller's stream, allocates nothing and returns cudaGetLastError().
//
// h3_hash (ports _h3_hash_block, bloom.py:62): byte-sliced H3, (N,)
//   addresses -> (N, M) global positions.  Bound by the bytes it moves (4 B
//   in and 4*M B out an address, the table once).  Design (redesigned for
//   Hopper): the packed byte table -- for each (byte slice, byte value) all
//   M segment hashes of that byte in one 64-bit word (M x log_seg = 36 bits
//   at the paper's geometry; more words an entry past 64 bits), 8 KB, read
//   through L1 and never staged; one thread an address: 4 gathers and 3
//   XORs for all segments, the positions cut out with shifts and stored as
//   one 16-byte store (the paper's geometry compiled fixed; any other spec
//   at run time, as many words an entry as its M segments need; a 32-bit
//   line id meets only the first 4 byte slices, so a spec of more address
//   bits hashes with those).  The previous design staged the 16 KB
//   uint32 tables in every block (4.3 MB of L2 reads at 262,144 lines) and
//   gathered 16 times an address.  Three designs were timed side by side
//   in one run on an H100 80GB HBM3 at 700 W, at 262,144 lines and at
//   LazySync's 16,384 ids (PERF.md, section 6, has the run):
//   - this one, the packed table through L1: 0.00372 and 0.00237 ms;
//   - the parity form of h3_parity.cuh (36 AND + POPC an address, the
//     masks a __grid_constant__ parameter, as B2/B3/B8 hash): 0.00518 ms,
//     its 9.4 M POPCs at 16 a clock an SM costing more issue time than the
//     table's bytes, and 0.00238 ms, a tie near the launch floor;
//   - the packed table staged once a block, in grids of 132, 264, 528 and
//     1,056 blocks: 0.00641 to 0.00406 ms and 0.00246 to 0.00297 ms,
//     slower at both shapes (an L2 round trip and a barrier before any
//     address).
//
// bloom_insert (ports bloom_insert_pallas, bloom.py:135): OR hashed
//   positions into packed signatures, either from an id list with a
//   validity mask or from a packed line bitmap (register = line % R, the
//   CPUWriteSet bank), for one list or two (the LazyPIM window's read and
//   write images, or its cpuws and conc banks) from one launch.  Bound by
//   the bytes of its inputs; at the window's shapes the launch is far above
//   both.  Design (redesigned for Hopper; the kernel is bloom_insert.cuh's,
//   shared with bloom_insert_onehot, and its note has the details): no
//   table staging -- the hash is the parity form of h3_parity.cuh, its
//   column masks a __grid_constant__ parameter (built with the paper's
//   geometry fixed, so the masks are instruction operands, and for any
//   spec under the mask cap); the blocks of a (list, lane) form one
//   thread-block cluster whose shared memory holds the output words, one
//   slice a block, ORed into through distributed shared memory and stored
//   once, so the output is allocated with torch.empty and needs no zero
//   fill.  An id list is one block a (list, lane).  A bitmap takes a
//   cluster of one block a 1,024 words, at most 8, so the window's
//   262,144-line bitmaps (8,192 words) take 8 blocks a (bitmap, lane); the
//   other design, one block a (bitmap, lane) walking all 8,192 words, was
//   slower when both were timed at the window's bank pair shape.  A spec
//   with more than 512 column masks (M * log2(seg_bits), e.g. 128 segments
//   of 32 bits) is inserted in passes of whole segments, each ORing into
//   the words the last one stored; a bank too large for 8 blocks' shared
//   memory takes as many blocks as it needs, up to the cluster's 8.

// bloom_query (ports bloom_query_pallas, bloom.py:205): per-line
//   membership of the lines set in a packed bitmap, ANDed with that bitmap
//   and packed 32 lines a word; given a second bitmap, the same membership
//   ANDed with it too, from the same launch (the LazyPIM window asks each
//   signature once for two bitmaps, as the reference's line_sig_hits does).
//   Bound by the bytes of the bitmaps and the signature at the window's
//   shapes, with the launch itself far above both.  Design (redesigned for
//   Hopper): no table staging -- the hash is the parity form of
//   h3_parity.cuh, its column masks a __grid_constant__ parameter read
//   from the constant bank (compiled with the paper's geometry fixed, so
//   the masks are instruction operands); a warp owns 4 consecutive words
//   (its first 4 lanes load them, and the union of the two bitmaps' words)
//   and 8 warps a block, so the per-window shape (3 lanes x 8,192 words) is
//   768 blocks, one wave on the card; the warp walks only its nonzero words
//   (one ballot finds them, a shuffle hands each word to every lane), each
//   lane whose line is set hashes it, stopping at the first clear bit,
//   against the lane's signature staged in shared memory (NW words, 256 B
//   for the paper's geometry); one ballot packs the word for its owner,
//   which writes both masked results.  Lines past num_lines stay zero.
//   Lanes sit on gridDim.y; past its 65,535 a block walks several lanes.
//   A spec with more than 512 column masks is queried in passes of whole
//   segments, each pass asked only for the lines the last one kept.

// bloom_intersect (ports bloom_intersect_pallas, bloom.py:316): the
//   AND-prefilter, true iff every segment of a & b has a set bit.  Bound
//   by bytes.  Design: one warp per row, a per-thread segment mask and
//   one __reduce_or_sync a run of 32 segments (one run at M <= 32, the
//   next run only while every segment so far met).  Pair-and-any form (what the LazyPIM window
//   launches): both CPUWriteSet banks of a window (cpuws and conc, L lanes
//   x R registers each) against the lanes' read images, and per bank and
//   lane whether ANY register passes -- the two conflict checks of a
//   window and their .any over registers in one launch.  Bound by the
//   bytes of the two banks and the images (~25 KB at the window's 3 lanes
//   x 16 registers x 64 words), far under the launch itself.  Design: one
//   block a lane, one warp a register (2R warps, at most 32, striding past
//   that), so every register's words are in flight at once; each warp
//   reads the lane's image words it needs once (2 a thread at 64 words),
//   tests its register with one __reduce_or_sync, and the block ORs the
//   warps' verdicts in shared memory.  (One warp a lane walking all 2R
//   registers would put the window's 96 register reads behind each other
//   in 3 warps.)
//
// bloom_detect_conflicts (ports bloom_detect_conflicts_pallas,
//   bloom.py:266, kernel _conflict_kernel :241): LazySync's fused hash ->
//   membership in each of G <= 16 packed group signatures -> hit-group
//   count.  Bound by bytes at the shapes LazySync gives it (4 B in and 4 B
//   out an address, G x 64 words of signature and the 8 KB table once), far
//   under the launch.  The TPU kernel does its word lookup as a one-hot
//   (BLK*M, W) select and sum, because a TPU has no cheap gather.  Design
//   (redesigned for Hopper): h3_hash's packed table through L1, and the
//   signatures staged transposed -- for each of the sig_bits positions a
//   G-bit mask of the groups holding it (4 KB at 2,048 bits), built in
//   shared memory from the G x NW words read in one coalesced pass, 8
//   masks a thread by a multiply that spreads a byte's bits 16 apart; an
//   address then costs M mask lookups, hit = AND_m mask[p_m], stopping at
//   0, and popc(hit).  The first address's hash is issued before the
//   staging barrier.  The grid is one block a 256 addresses, at most one
//   wave (64 blocks at N = 16,384; one at the capture's N = 192).  The
//   previous design staged the 16 KB uint32 tables and the G x NW words in
//   every block and read M x G words an address.  Signatures past 2^15
//   bits take the direct route (no staging, G words of each position read
//   through L1), chosen by the spec before launch and counted.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "bloom_insert.cuh"
#include "h3_parity.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 16;  // bloom_detect_conflicts' uint16 group masks

__device__ __forceinline__ void copy_to_shared(uint32_t* dst,
                                               const uint32_t* __restrict__ src,
                                               int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// ---------------------------------------------------------------------------
// The packed byte table (h3_hash, bloom_detect_conflicts).  ptab (S, 256, E)
// uint64: word e of entry (k, v) holds, for the P = 64 / log_seg segments
// m = e * P + j < M, segment m's H3 hash of byte value v in byte slice k at
// bits [j * log_seg, (j + 1) * log_seg).  XOR is bitwise, so XORing the S
// entries of an address's bytes hashes all P segments at once; the paper's
// geometry (M = 4 segments of 9 bits, S = 4) is one word an entry (8 KB).
// The table is read through L1 (__ldg), never staged.
// ---------------------------------------------------------------------------

using u64 = unsigned long long;

// Word e of the XOR of address a's S entries (E words an entry).
template <int SC>
__device__ __forceinline__ u64 packed_word(const u64* __restrict__ ptab, uint32_t a, int e,
                                           int S, int E) {
  if constexpr (SC > 0) {
    u64 h = __ldg(ptab + (a & 0xFFu));
#pragma unroll
    for (int k = 1; k < SC; ++k) h ^= __ldg(ptab + (k << 8) + ((a >> (8 * k)) & 0xFFu));
    return h;
  } else {
    u64 h = 0ull;
    for (int k = 0; k < S; ++k) {
      h ^= __ldg(ptab + (static_cast<size_t>((k << 8) + ((a >> (8 * k)) & 0xFFu)) * E + e));
    }
    return h;
  }
}

// Global position of the segment at field j of a packed word: its hash, at
// bits [j * log_seg, (j + 1) * log_seg), with the segment's offset m << log_seg.
__device__ __forceinline__ uint32_t packed_position(u64 h, int m, int j, int log_seg) {
  const uint32_t field =
      static_cast<uint32_t>(h >> (j * log_seg)) & ((1u << log_seg) - 1u);
  return (static_cast<uint32_t>(m) << log_seg) | field;
}

// One thread an address: addrs (n,) -> out (n, M) global positions.  With
// the paper's geometry fixed (MC = 4, LOGC = 9, S = 4) one word holds all
// four segments and the four positions go out as one 16-byte store.
template <int MC, int LOGC>
__global__ void __launch_bounds__(kThreads)
h3_hash_kernel(const uint32_t* __restrict__ addrs, const u64* __restrict__ ptab,
               int32_t* __restrict__ out, int n, int S, int M, int log_seg) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t a = addrs[i];
  if constexpr (MC > 0) {
    static_assert(MC == 4 && MC * LOGC <= 64, "the paper build stores one int4");
    const u64 h = packed_word<4>(ptab, a, 0, 4, 1);
    reinterpret_cast<int4*>(out)[i] = make_int4(
        packed_position(h, 0, 0, LOGC), packed_position(h, 1, 1, LOGC),
        packed_position(h, 2, 2, LOGC), packed_position(h, 3, 3, LOGC));
  } else {
    const int P = 64 / log_seg, E = (M + P - 1) / P;
    int32_t* o = out + static_cast<size_t>(i) * M;
    for (int e = 0, m = 0; e < E; ++e) {
      const u64 h = packed_word<0>(ptab, a, e, S, E);
      for (int j = 0; j < P && m < M; ++j, ++m) o[m] = packed_position(h, m, j, log_seg);
    }
  }
}

// grid (ceil(NWL / kQueryBlockWords), min(L, 65,535)): sig (L, NW),
// words_a / words_b (L, NWL) -> out_a / out_b (L, NWL); words_b and out_b
// null for one bitmap.  kLaneLoop, taken only past 65,535 lanes, walks the
// lanes y, y + gridDim.y, ... in each block; without it a block answers its
// one lane with no loop around it (the loop, built in at every lane count,
// took registers and time at the paper's shapes: PERF.md, section 6).
constexpr int kQueryWarpWords = 4;                                  // words a warp
constexpr int kQueryBlockWords = kQueryWarpWords * (kThreads / 32);  // words a block

template <int MC, int LOGC>
__device__ __forceinline__ void query_lane(const uint32_t* __restrict__ sig,
                                           const uint32_t* __restrict__ words_a,
                                           const uint32_t* __restrict__ words_b,
                                           const h3p::Columns& cols, uint32_t* __restrict__ out_a,
                                           uint32_t* __restrict__ out_b, uint32_t* ssig,
                                           int lane, int NWL, int num_lines, int M,
                                           int log_seg, int NW) {
  const int t = threadIdx.x & 31;
  const int w0 = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * kQueryWarpWords;
  const int w = w0 + t;  // lanes t < kQueryWarpWords own word w
  const bool owner = t < kQueryWarpWords && w < NWL;
  const size_t k = static_cast<size_t>(lane) * NWL + w;
  uint32_t a = 0u, b = 0u;
  if (owner) {
    a = words_a[k];
    if (words_b != nullptr) b = words_b[k];
  }
  copy_to_shared(ssig, sig + static_cast<size_t>(lane) * NW, NW);
  __syncthreads();
  uint32_t u = a | b;
  const int rest = num_lines - w * 32;  // lines of word w below num_lines
  if (rest < 32) u &= rest <= 0 ? 0u : (1u << rest) - 1u;
  uint32_t hit = 0u;  // the owner's membership word
  for (uint32_t pending = __ballot_sync(0xFFFFFFFFu, u != 0u); pending;
       pending &= pending - 1u) {
    const int i = __ffs(pending) - 1;
    const uint32_t ui = __shfl_sync(0xFFFFFFFFu, u, i);
    const uint32_t line = static_cast<uint32_t>(w0 + i) * 32u + static_cast<uint32_t>(t);
    const bool member = ((ui >> t) & 1u) &&
                        h3p::all_set<MC, LOGC>(cols, ssig, line, M, log_seg);
    const uint32_t packed = __ballot_sync(0xFFFFFFFFu, member);
    if (t == i) hit = packed;
  }
  if (owner) {
    out_a[k] = a & hit;
    if (out_b != nullptr) out_b[k] = b & hit;
  }
}

template <int MC, int LOGC, bool kLaneLoop>
__global__ void __launch_bounds__(kThreads)
query_kernel(const uint32_t* __restrict__ sig, const uint32_t* __restrict__ words_a,
             const uint32_t* __restrict__ words_b,
             const __grid_constant__ h3p::Columns cols,
             uint32_t* __restrict__ out_a, uint32_t* __restrict__ out_b, int L, int NWL,
             int num_lines, int M, int log_seg, int NW) {
  extern __shared__ uint32_t ssig[];
  if constexpr (kLaneLoop) {
    for (int lane = blockIdx.y; lane < L; lane += gridDim.y) {
      if (lane != static_cast<int>(blockIdx.y)) __syncthreads();  // the last ssig is read
      query_lane<MC, LOGC>(sig, words_a, words_b, cols, out_a, out_b, ssig, lane, NWL,
                           num_lines, M, log_seg, NW);
    }
  } else {
    query_lane<MC, LOGC>(sig, words_a, words_b, cols, out_a, out_b, ssig, blockIdx.y, NWL,
                         num_lines, M, log_seg, NW);
  }
}

// True iff every one of the M segments (WPS words each) of row & img has a
// set bit; called by a whole warp, t its lane: one bit a segment of a
// warp-reduced mask.  kRuns, taken only for M > 32, takes the segments 32
// at a time, stopping at the first run with an empty segment; without it
// one run covers them all (the run loop, built in at every M, took time at
// the paper's shapes: PERF.md, section 6).
template <bool kRuns>
__device__ __forceinline__ bool segments_meet(const uint32_t* __restrict__ row,
                                              const uint32_t* __restrict__ img, int t,
                                              int NW, int WPS, int M) {
  if constexpr (!kRuns) {
    uint32_t segs = 0u;
    for (int j = t; j < NW; j += 32) {
      if (row[j] & img[j]) segs |= 1u << (j / WPS);
    }
    const uint32_t full = M >= 32 ? 0xFFFFFFFFu : ((1u << M) - 1u);
    return __reduce_or_sync(0xFFFFFFFFu, segs) == full;
  } else {
    for (int s0 = 0; s0 < M; s0 += 32) {
      const int nseg = min(32, M - s0);
      const int j0 = s0 * WPS, j1 = j0 + nseg * WPS;
      uint32_t segs = 0u;
      for (int j = j0 + t; j < j1; j += 32) {
        if (row[j] & img[j]) segs |= 1u << ((j - j0) / WPS);
      }
      const uint32_t full = nseg == 32 ? 0xFFFFFFFFu : ((1u << nseg) - 1u);
      if (__reduce_or_sync(0xFFFFFFFFu, segs) != full) return false;
    }
    return true;
  }
}

// One warp per row: a (B, NW), b (B / R, NW), row i pairs with b[i / R].
template <bool kRuns>
__global__ void intersect_kernel(const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ b,
                                 uint8_t* __restrict__ out, int B, int R,
                                 int NW, int WPS, int M) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (row >= B) return;  // uniform per warp
  const bool pass = segments_meet<kRuns>(a + static_cast<size_t>(row) * NW,
                                         b + static_cast<size_t>(row / R) * NW, t, NW, WPS, M);
  if (t == 0) out[row] = pass ? 1 : 0;
}

// One block a lane, one warp a register: a and a_b (L * R, NW) banks, b (L,
// NW) read images -> out (2, L): out[k][l] = any register r of bank k of
// lane l passes the prefilter against b[l].
template <bool kRuns>
__global__ void intersect_pair_kernel(const uint32_t* __restrict__ a,
                                      const uint32_t* __restrict__ a_b,
                                      const uint32_t* __restrict__ b,
                                      uint8_t* __restrict__ out, int L, int R,
                                      int NW, int WPS, int M) {
  __shared__ int hit[2];
  const int lane = blockIdx.x;
  const int w = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  if (threadIdx.x < 2) hit[threadIdx.x] = 0;
  __syncthreads();
  const uint32_t* img = b + static_cast<size_t>(lane) * NW;
  bool found[2] = {false, false};
  for (int reg = w; reg < 2 * R; reg += blockDim.x >> 5) {  // uniform per warp
    const int bank = reg >= R;
    const uint32_t* row = (bank ? a_b : a) +
                          (static_cast<size_t>(lane) * R + (reg - bank * R)) * NW;
    if (segments_meet<kRuns>(row, img, t, NW, WPS, M)) found[bank] = true;
  }
  if (t == 0) {
    if (found[0]) hit[0] = 1;  // every writer writes 1
    if (found[1]) hit[1] = 1;
  }
  __syncthreads();
  if (threadIdx.x < 2) out[threadIdx.x * L + lane] = static_cast<uint8_t>(hit[threadIdx.x]);
}

// Bits j = 0..3 of a 4-bit n moved to bits 16 j: the four partial products
// of the multiply land on disjoint bits, so none carries.
__device__ __forceinline__ u64 spread4(uint32_t n) {
  return (static_cast<u64>(n) * 0x0000200040008001ull) & 0x0001000100010001ull;
}

// sigs (G, NW), addrs (N,) -> out (N,): groups holding every position.
// TRANSPOSED: each block copies the G x NW signature words to shared memory
// in one coalesced pass, then builds smask[p], bit g set iff group g holds
// position p (NW * 32 uint16 masks, 4 KB at 2,048 bits), so a position is
// tested against every group with one lookup.  A thread builds 8 masks at
// a time: for each group one byte of a word, spread to the 8 masks' bit g
// by a multiply, stored as 16 bytes.  The paper build hashes its first
// address before the staging barrier, so the table gathers overlap the
// signature reads.  Otherwise (signatures too large to stage) each
// position reads its word of every group through L1.  A grid-stride loop
// over at most one wave of blocks.
template <int MC, int LOGC, bool TRANSPOSED>
__global__ void __launch_bounds__(kThreads)
detect_conflicts_kernel(const uint32_t* __restrict__ sigs,
                        const uint32_t* __restrict__ addrs, const u64* __restrict__ ptab,
                        int32_t* __restrict__ out, int n, int G, int NW, int S, int M,
                        int log_seg) {
  extern __shared__ uint4 sdyn[];  // TRANSPOSED: the masks, then the G * NW words
  uint16_t* smask = reinterpret_cast<uint16_t*>(sdyn);
  uint32_t* ssig = reinterpret_cast<uint32_t*>(smask + NW * 32);
  int i = blockIdx.x * kThreads + threadIdx.x;
  u64 h_first = 0ull;  // the paper build's hash of this thread's first address
  if constexpr (MC > 0) {
    if (i < n) h_first = packed_word<4>(ptab, addrs[i], 0, 4, 1);
  }
  if constexpr (TRANSPOSED) {
    for (int q = threadIdx.x; q < G * NW; q += kThreads) ssig[q] = __ldg(sigs + q);
    __syncthreads();
    for (int t = threadIdx.x; t < NW * 4; t += kThreads) {  // bits b0..b0 + 7 of word w
      const int w = t >> 2, b0 = (t & 3) * 8;
      u64 lo = 0ull, hi = 0ull;
#pragma unroll 4
      for (int g = 0; g < G; ++g) {
        const uint32_t byte = (ssig[g * NW + w] >> b0) & 0xFFu;
        lo |= spread4(byte & 0xFu) << g;
        hi |= spread4(byte >> 4) << g;
      }
      reinterpret_cast<ulonglong2*>(smask)[t] = make_ulonglong2(lo, hi);
    }
    __syncthreads();
  }
  const uint32_t groups = (1u << G) - 1u;
  // hit &= the groups holding position p; false once no group is left
  auto holds = [&](uint32_t& hit, uint32_t p) {
    if constexpr (TRANSPOSED) {
      hit &= smask[p];
    } else {
      const uint32_t w = p >> 5, b = p & 31u;
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        if (g < G && !((__ldg(sigs + g * NW + w) >> b) & 1u)) hit &= ~(1u << g);
      }
    }
    return hit != 0u;
  };
  for (bool first = true; i < n; i += gridDim.x * kThreads, first = false) {
    uint32_t hit = groups;
    if constexpr (MC > 0) {
      const u64 h = first ? h_first : packed_word<4>(ptab, addrs[i], 0, 4, 1);
#pragma unroll
      for (int m = 0; m < MC; ++m) {
        if (!holds(hit, packed_position(h, m, m, LOGC))) break;
      }
    } else {
      const uint32_t a = addrs[i];
      const int P = 64 / log_seg, E = (M + P - 1) / P;
      for (int e = 0, m = 0; e < E && hit; ++e) {
        const u64 h = packed_word<0>(ptab, a, e, S, E);
        for (int j = 0; j < P && m < M; ++j, ++m) {
          if (!holds(hit, packed_position(h, m, j, log_seg))) break;
        }
      }
    }
    out[i] = __popc(hit);
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int MC, int LOGC>
int query_launch(const void* sig, const void* words_a, const void* words_b,
                 const void* columns, void* out_a, void* out_b, int L, int NWL,
                 int num_lines, int M, int log_seg, int m0, int NW, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(NW) * sizeof(uint32_t);
  auto kernel = L > bins::kMaxLanesY ? query_kernel<MC, LOGC, true>
                                     : query_kernel<MC, LOGC, false>;
  if (int rc = set_smem(kernel, smem)) return rc;
  const dim3 grid((NWL + kQueryBlockWords - 1) / kQueryBlockWords, std::min(L, bins::kMaxLanesY));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(sig), static_cast<const uint32_t*>(words_a),
      static_cast<const uint32_t*>(words_b), h3p::load_columns(columns, M, log_seg, m0),
      static_cast<uint32_t*>(out_a), static_cast<uint32_t*>(out_b), L, NWL, num_lines,
      M, log_seg, NW);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int attributes(Kernel kernel, int* out) {
  cudaFuncAttributes attr;
  if (cudaError_t rc = cudaFuncGetAttributes(&attr, kernel)) return static_cast<int>(rc);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}

constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory without opting in

// The paper's geometry, which the packed-table kernels compile with fixed:
// M = 4 segments of 512 bits over 4 byte slices.
inline bool paper_packed(int S, int M, int log_seg) {
  return S == 4 && h3p::paper_geometry(M, log_seg);
}

}  // namespace

extern "C" {

// ptab (S, 256, E) packed byte table (u64) -> out (n, M); n >= 1.
int h3_hash_launch(const void* addrs, const void* ptab, void* out, int n, int S, int M,
                   int log_seg, void* stream) {
  auto kernel = paper_packed(S, M, log_seg) ? h3_hash_kernel<h3p::kPaperM, h3p::kPaperLog>
                                            : h3_hash_kernel<0, 0>;
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(addrs), static_cast<const u64*>(ptab),
      static_cast<int32_t*>(out), n, S, M, log_seg);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local memory (bytes a thread) and static shared memory of the
// loaded h3_hash kernel, three ints a build: the paper's geometry fixed,
// then any spec.
int h3_hash_attributes(void* out) {
  int* o = static_cast<int*>(out);
  if (int rc = attributes(h3_hash_kernel<h3p::kPaperM, h3p::kPaperLog>, o)) return rc;
  return attributes(h3_hash_kernel<0, 0>, o + 3);
}

// k = 1 or 2 lists (ids_b / words_b and valid_b then unused or read);
// out (k, L, R, NW).  columns holds the M segments from m0 on of one pass;
// or_out ORs in what out holds (every pass but the first).
int bloom_insert_ids_launch(const void* ids_a, const void* valid_a, const void* ids_b,
                            const void* valid_b, const void* columns, void* out, int k,
                            int L, int A_a, int A_b, int M, int log_seg, int m0, int or_out,
                            int R, int NW, void* stream) {
  const bins::Args args{ids_a, ids_b, static_cast<const uint8_t*>(valid_a),
                        static_cast<const uint8_t*>(valid_b), nullptr,
                        static_cast<uint32_t*>(out), L, A_a, A_b, 0, M, log_seg, R, NW,
                        m0, or_out};
  return bins::launch_any<false>(args, k, columns, stream);
}

int bloom_insert_bitmap_launch(const void* words_a, const void* words_b, const void* columns,
                               void* out, int k, int L, int NWL, int num_lines, int M,
                               int log_seg, int m0, int or_out, int R, int NW, void* stream) {
  const bins::Args args{words_a, words_b, nullptr, nullptr, nullptr,
                        static_cast<uint32_t*>(out), L, NWL, NWL, num_lines, M, log_seg,
                        R, NW, m0, or_out};
  return bins::launch_any<true>(args, k, columns, stream);
}

// Registers, local memory (bytes a thread) and static shared memory of the
// loaded insert kernel, as cudaFuncGetAttributes reads them, three ints a
// build: the id form with the paper's geometry fixed, the id form for any
// spec, then the bitmap form the same two ways.
int bloom_insert_attributes(void* out) {
  int* o = static_cast<int*>(out);
  if (int rc = bins::build_attributes<h3p::kPaperM, h3p::kPaperLog, false>(o)) return rc;
  if (int rc = bins::build_attributes<0, 0, false>(o + 3)) return rc;
  if (int rc = bins::build_attributes<h3p::kPaperM, h3p::kPaperLog, true>(o + 6)) return rc;
  return bins::build_attributes<0, 0, true>(o + 9);
}

// columns holds the M segments from m0 on of one pass (the words of a
// later pass are the earlier pass's outputs).
int bloom_query_launch(const void* sig, const void* words_a, const void* words_b,
                       const void* columns, void* out_a, void* out_b, int L,
                       int NWL, int num_lines, int M, int log_seg, int m0, int NW,
                       void* stream) {
  auto launch = h3p::paper_geometry(M, log_seg, m0)
                    ? query_launch<h3p::kPaperM, h3p::kPaperLog>
                    : query_launch<0, 0>;
  return launch(sig, words_a, words_b, columns, out_a, out_b, L, NWL, num_lines, M,
                log_seg, m0, NW, static_cast<cudaStream_t>(stream));
}

// Registers, local memory (bytes a thread) and static shared memory of the
// loaded query kernel, as cudaFuncGetAttributes reads them, into out[0..2]
// for the paper's geometry and out[3..5] for any other.
int bloom_query_attributes(void* out) {
  int* o = static_cast<int*>(out);
  if (int rc = attributes(query_kernel<h3p::kPaperM, h3p::kPaperLog, false>, o)) return rc;
  return attributes(query_kernel<0, 0, false>, o + 3);
}

int bloom_intersect_launch(const void* a, const void* b, void* out, int B,
                           int R, int NW, int WPS, int M, void* stream) {
  const int rows_per_block = kThreads / 32;
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  auto kernel = M > 32 ? intersect_kernel<true> : intersect_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint8_t*>(out), B, R, NW, WPS, M);
  return static_cast<int>(cudaGetLastError());
}

// a, a_b (L * R, NW), b (L, NW) -> out (2, L); L >= 1, R >= 1.
int bloom_intersect_pair_launch(const void* a, const void* a_b, const void* b, void* out,
                                int L, int R, int NW, int WPS, int M, void* stream) {
  const int threads = 32 * std::min(2 * R, 32);
  auto kernel = M > 32 ? intersect_pair_kernel<true> : intersect_pair_kernel<false>;
  kernel<<<L, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(a_b),
      static_cast<const uint32_t*>(b), static_cast<uint8_t*>(out), L, R, NW, WPS, M);
  return static_cast<int>(cudaGetLastError());
}

// sigs (G, NW) with G <= 16, addrs (n,) -> out (n,); n >= 1.  transposed
// picks the staged group masks (G * NW words and NW * 32 masks of shared
// memory), else each position reads the signatures' words.  sms, the
// card's SM count, caps the grid at one wave.
int bloom_detect_conflicts_launch(const void* sigs, const void* addrs, const void* ptab,
                                  void* out, int n, int G, int NW, int S, int M,
                                  int log_seg, int transposed, int sms, void* stream) {
  const size_t smem = transposed ? static_cast<size_t>(NW) * (G * sizeof(uint32_t) +
                                                              32 * sizeof(uint16_t))
                                 : 0;
  auto kernel = !transposed ? detect_conflicts_kernel<0, 0, false>
                : paper_packed(S, M, log_seg)
                    ? detect_conflicts_kernel<h3p::kPaperM, h3p::kPaperLog, true>
                    : detect_conflicts_kernel<0, 0, true>;
  if (smem > kDefaultSmem) {
    if (int rc = set_smem(kernel, smem)) return rc;
  }
  const int blocks = std::min((n + kThreads - 1) / kThreads, sms);  // one wave
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(sigs), static_cast<const uint32_t*>(addrs),
      static_cast<const u64*>(ptab), static_cast<int32_t*>(out), n, G, NW, S, M, log_seg);
  return static_cast<int>(cudaGetLastError());
}

// The same three ints for the loaded bloom_detect_conflicts kernel: the
// transposed route with the paper's geometry fixed, for any spec, then the
// direct route (any spec).
int bloom_detect_conflicts_attributes(void* out) {
  int* o = static_cast<int*>(out);
  if (int rc = attributes(detect_conflicts_kernel<h3p::kPaperM, h3p::kPaperLog, true>, o)) {
    return rc;
  }
  if (int rc = attributes(detect_conflicts_kernel<0, 0, true>, o + 3)) return rc;
  return attributes(detect_conflicts_kernel<0, 0, false>, o + 6);
}

}  // extern "C"
