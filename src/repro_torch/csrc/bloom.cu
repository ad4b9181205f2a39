// Bloom-signature kernels of the LazyPIM simulator for Hopper (sm_90a).
//
// Five kernels, each the CUDA counterpart of a Pallas TPU kernel in
// src/repro/kernels/bloom/bloom.py.  Packed words are uint32 here; the
// PyTorch side stores the same bits as int32.  Every kernel launches on
// the caller's stream, allocates nothing and returns cudaGetLastError().
//
// h3_hash (ports _h3_hash_block, bloom.py:62): byte-sliced H3, four
//   table gathers and three XORs per (address, segment).  Bound by the
//   bytes it moves (4 B in, 4*M B out per address).  Design: the
//   offset-folded tables (S x 256 x M uint32, 16 KB for the paper's
//   geometry) are staged once per block in shared memory and a
//   grid-stride loop of a few hundred blocks amortizes that load; the
//   gathers then hit shared memory instead of device memory.
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
//   slower when both were timed at the window's bank pair shape.

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

// bloom_intersect (ports bloom_intersect_pallas, bloom.py:316): the
//   AND-prefilter, true iff every segment of a & b has a set bit.  Bound
//   by bytes.  Design: one warp per row, a per-thread segment mask and
//   one __reduce_or_sync.  Pair-and-any form (what the LazyPIM window
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
//   bloom.py:266, kernel _conflict_kernel :240): LazySync's fused hash ->
//   membership in each of G packed group signatures -> hit-group count.
//   Bound by bytes at the shapes LazySync gives it (4 B in and 4 B out
//   per address; G x 64 words of signature and the 16 KB of tables are
//   read once per block).  The TPU kernel does its word lookup as a
//   one-hot (BLK*M, W) select and sum, because a TPU has no cheap
//   gather; on Hopper one thread per address gathers the word it needs
//   straight from shared memory.  Design: the H3 tables and all G
//   signatures (G <= 16) are staged in shared memory once per block; a
//   grid-stride loop over a bounded grid amortizes that staging; each
//   thread hashes its address once per segment (the h3 device function
//   shared with h3_hash) and tests that position in every group, so no
//   position is stored.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "bloom_insert.cuh"
#include "h3_parity.cuh"

namespace {

constexpr int kByteVals = 256;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t h3(const uint32_t* __restrict__ tab,
                                       uint32_t a, int m, int S, int M) {
  uint32_t h = tab[(a & 0xFFu) * M + m];
  for (int k = 1; k < S; ++k) {
    h ^= tab[(k * kByteVals + ((a >> (8 * k)) & 0xFFu)) * M + m];
  }
  return h;
}

__device__ __forceinline__ void copy_to_shared(uint32_t* dst,
                                               const uint32_t* __restrict__ src,
                                               int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

__global__ void h3_hash_kernel(const uint32_t* __restrict__ addrs,
                               const uint32_t* __restrict__ tabs,
                               int32_t* __restrict__ out, int n, int S, int M) {
  extern __shared__ uint32_t smem[];
  copy_to_shared(smem, tabs, S * kByteVals * M);
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const uint32_t a = addrs[i];
    for (int m = 0; m < M; ++m) {
      out[static_cast<size_t>(i) * M + m] = static_cast<int32_t>(h3(smem, a, m, S, M));
    }
  }
}

// grid (ceil(NWL / kQueryBlockWords), L): sig (L, NW), words_a / words_b
// (L, NWL) -> out_a / out_b (L, NWL); words_b and out_b null for one bitmap.
constexpr int kQueryWarpWords = 4;                                  // words a warp
constexpr int kQueryBlockWords = kQueryWarpWords * (kThreads / 32);  // words a block

template <int MC, int LOGC>
__global__ void __launch_bounds__(kThreads)
query_kernel(const uint32_t* __restrict__ sig, const uint32_t* __restrict__ words_a,
             const uint32_t* __restrict__ words_b,
             const __grid_constant__ h3p::Columns cols,
             uint32_t* __restrict__ out_a, uint32_t* __restrict__ out_b, int NWL,
             int num_lines, int M, int log_seg, int NW) {
  extern __shared__ uint32_t ssig[];
  const int lane = blockIdx.y;
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

// One warp per row: a (B, NW), b (B / R, NW), row i pairs with b[i / R].
__global__ void intersect_kernel(const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ b,
                                 uint8_t* __restrict__ out, int B, int R,
                                 int NW, int WPS, int M) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (row >= B) return;  // uniform per warp
  const uint32_t* ar = a + static_cast<size_t>(row) * NW;
  const uint32_t* br = b + static_cast<size_t>(row / R) * NW;
  uint32_t segs = 0u;
  for (int j = t; j < NW; j += 32) {
    if (ar[j] & br[j]) segs |= 1u << (j / WPS);
  }
  segs = __reduce_or_sync(0xFFFFFFFFu, segs);
  const uint32_t full = M >= 32 ? 0xFFFFFFFFu : ((1u << M) - 1u);
  if (t == 0) out[row] = segs == full ? 1 : 0;
}

// One block a lane, one warp a register: a and a_b (L * R, NW) banks, b (L,
// NW) read images -> out (2, L): out[k][l] = any register r of bank k of
// lane l passes the prefilter against b[l].
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
  const uint32_t full = M >= 32 ? 0xFFFFFFFFu : ((1u << M) - 1u);
  bool found[2] = {false, false};
  for (int reg = w; reg < 2 * R; reg += blockDim.x >> 5) {  // uniform per warp
    const int bank = reg >= R;
    const uint32_t* row = (bank ? a_b : a) +
                          (static_cast<size_t>(lane) * R + (reg - bank * R)) * NW;
    uint32_t segs = 0u;
    for (int j = t; j < NW; j += 32) {
      if (row[j] & img[j]) segs |= 1u << (j / WPS);
    }
    if (__reduce_or_sync(0xFFFFFFFFu, segs) == full) found[bank] = true;
  }
  if (t == 0) {
    if (found[0]) hit[0] = 1;  // every writer writes 1
    if (found[1]) hit[1] = 1;
  }
  __syncthreads();
  if (threadIdx.x < 2) out[threadIdx.x * L + lane] = static_cast<uint8_t>(hit[threadIdx.x]);
}

// sigs (G, NW), addrs (N,) -> out (N,): groups holding every position.
__global__ void detect_conflicts_kernel(const uint32_t* __restrict__ sigs,
                                        const uint32_t* __restrict__ addrs,
                                        const uint32_t* __restrict__ tabs,
                                        int32_t* __restrict__ out, int n, int G,
                                        int NW, int S, int M) {
  extern __shared__ uint32_t smem[];
  uint32_t* stab = smem;
  uint32_t* ssig = smem + S * kByteVals * M;
  copy_to_shared(stab, tabs, S * kByteVals * M);
  copy_to_shared(ssig, sigs, G * NW);
  __syncthreads();
  const uint32_t nbits = static_cast<uint32_t>(NW) * 32u;
  constexpr int kMaxGroups = 16;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const uint32_t a = addrs[i];
    uint32_t hit = (1u << G) - 1u;  // groups still holding every position
    for (int m = 0; m < M && hit; ++m) {
      const uint32_t p = h3(stab, a, m, S, M);
      if (p >= nbits) { hit = 0u; break; }
      const uint32_t w = p >> 5, b = 1u << (p & 31u);
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        if (g < G && !(ssig[g * NW + w] & b)) hit &= ~(1u << g);
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
                 int num_lines, int M, int log_seg, int NW, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(NW) * sizeof(uint32_t);
  if (int rc = set_smem(query_kernel<MC, LOGC>, smem)) return rc;
  const dim3 grid((NWL + kQueryBlockWords - 1) / kQueryBlockWords, L);
  query_kernel<MC, LOGC><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(sig), static_cast<const uint32_t*>(words_a),
      static_cast<const uint32_t*>(words_b), h3p::load_columns(columns, M, log_seg),
      static_cast<uint32_t*>(out_a), static_cast<uint32_t*>(out_b), NWL, num_lines,
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

}  // namespace

extern "C" {

int h3_hash_launch(const void* addrs, const void* tabs, void* out, int n,
                   int S, int M, void* stream) {
  const size_t smem = static_cast<size_t>(S) * kByteVals * M * sizeof(uint32_t);
  if (int rc = set_smem(h3_hash_kernel, smem)) return rc;
  const int blocks = std::min((n + kThreads - 1) / kThreads, 264);
  h3_hash_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(addrs), static_cast<const uint32_t*>(tabs),
      static_cast<int32_t*>(out), n, S, M);
  return static_cast<int>(cudaGetLastError());
}

// k = 1 or 2 lists (ids_b / words_b and valid_b then unused or read);
// out (k, L, R, NW).
int bloom_insert_ids_launch(const void* ids_a, const void* valid_a, const void* ids_b,
                            const void* valid_b, const void* columns, void* out, int k,
                            int L, int A_a, int A_b, int M, int log_seg, int R, int NW,
                            void* stream) {
  const bins::Args args{ids_a, ids_b, static_cast<const uint8_t*>(valid_a),
                        static_cast<const uint8_t*>(valid_b), nullptr,
                        static_cast<uint32_t*>(out), L, A_a, A_b, 0, M, log_seg, R, NW};
  return bins::launch_any<false>(args, k, columns, stream);
}

int bloom_insert_bitmap_launch(const void* words_a, const void* words_b, const void* columns,
                               void* out, int k, int L, int NWL, int num_lines, int M,
                               int log_seg, int R, int NW, void* stream) {
  const bins::Args args{words_a, words_b, nullptr, nullptr, nullptr,
                        static_cast<uint32_t*>(out), L, NWL, NWL, num_lines, M, log_seg,
                        R, NW};
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

int bloom_query_launch(const void* sig, const void* words_a, const void* words_b,
                       const void* columns, void* out_a, void* out_b, int L,
                       int NWL, int num_lines, int M, int log_seg, int NW,
                       void* stream) {
  auto launch = h3p::paper_geometry(M, log_seg)
                    ? query_launch<h3p::kPaperM, h3p::kPaperLog>
                    : query_launch<0, 0>;
  return launch(sig, words_a, words_b, columns, out_a, out_b, L, NWL, num_lines, M,
                log_seg, NW, static_cast<cudaStream_t>(stream));
}

// Registers, local memory (bytes a thread) and static shared memory of the
// loaded query kernel, as cudaFuncGetAttributes reads them, into out[0..2]
// for the paper's geometry and out[3..5] for any other.
int bloom_query_attributes(void* out) {
  int* o = static_cast<int*>(out);
  if (int rc = attributes(query_kernel<h3p::kPaperM, h3p::kPaperLog>, o)) return rc;
  return attributes(query_kernel<0, 0>, o + 3);
}

int bloom_intersect_launch(const void* a, const void* b, void* out, int B,
                           int R, int NW, int WPS, int M, void* stream) {
  const int rows_per_block = kThreads / 32;
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  intersect_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint8_t*>(out), B, R, NW, WPS, M);
  return static_cast<int>(cudaGetLastError());
}

// a, a_b (L * R, NW), b (L, NW) -> out (2, L); L >= 1, R >= 1.
int bloom_intersect_pair_launch(const void* a, const void* a_b, const void* b, void* out,
                                int L, int R, int NW, int WPS, int M, void* stream) {
  const int threads = 32 * std::min(2 * R, 32);
  intersect_pair_kernel<<<L, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(a_b),
      static_cast<const uint32_t*>(b), static_cast<uint8_t*>(out), L, R, NW, WPS, M);
  return static_cast<int>(cudaGetLastError());
}

int bloom_detect_conflicts_launch(const void* sigs, const void* addrs,
                                  const void* tabs, void* out, int n, int G,
                                  int NW, int S, int M, void* stream) {
  const size_t smem =
      (static_cast<size_t>(S) * kByteVals * M + static_cast<size_t>(G) * NW) *
      sizeof(uint32_t);
  if (int rc = set_smem(detect_conflicts_kernel, smem)) return rc;
  const int blocks = std::min((n + kThreads - 1) / kThreads, 264);
  detect_conflicts_kernel<<<blocks, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(sigs), static_cast<const uint32_t*>(addrs),
      static_cast<const uint32_t*>(tabs), static_cast<int32_t*>(out), n, G, NW,
      S, M);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
