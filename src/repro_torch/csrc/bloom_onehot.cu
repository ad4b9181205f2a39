// Seed one-hot Bloom-signature kernels of the LazyPIM simulator for Hopper
// (sm_90a): the CUDA counterparts of the two "seed" Pallas TPU kernels in
// src/repro/kernels/bloom/bloom.py that hash with the per-bit xor-fold H3
// (_h3_hash_block_xorfold, bloom.py:70) and keep the signature as an
// unpacked sig_bits-wide 0/1 image.  Both kernels here hash with the parity
// form of h3_parity.cuh, which gives the xor-fold's positions bit for bit.
// Addresses arrive as int32 bits and are read as uint32; packed words are
// uint32 here and int32 on the PyTorch side.  Both kernels are lane-batched
// (lanes on gridDim.y, walked in a loop only past its 65,535), launch on the
// caller's stream, allocate nothing and return cudaGetLastError().  A spec
// with more than 512 column masks is hashed in passes (h3_parity.cuh).
//
// bloom_insert_onehot (ports bloom_insert_pallas_onehot, bloom.py:367, body
//   _insert_kernel_onehot :350): out = sig | pack(onehot(H3(addrs) where
//   mask)), with sig optional (none: zero), for one address list or two
//   (the seed window's read and write images) from one launch.  Bound by
//   the bytes (5 an address and the signatures) at the seed path's shapes,
//   with the launch far above them.  The TPU kernel expands each position
//   against a sig_bits-wide iota and ORs the hits, because a TPU has no
//   cheap scatter.  Design (redesigned for Hopper; the kernel is
//   bloom_insert.cuh's, shared with bloom_insert): the hash is the parity
//   form (36 popc an address at the paper's geometry, against the
//   xor-fold's M * addr_bits = 128 select-XOR rounds), its column masks a
//   __grid_constant__ parameter; the blocks of a (list, lane), one a 1,024
//   addresses up to 8, form one thread-block cluster whose shared memory
//   holds the packed signature, one slice a block, ORed into through
//   distributed shared memory and stored once with the incoming signature
//   ORed in, so the wrapper neither fills nor clones the output.  The seed
//   window's 256-slot lists take one block a (list, lane), the whole-bitmap
//   call (N = num_lines) a cluster of 8.  The TPU kernel's one-hot byte
//   image, packed by a ballot (this kernel's design before), was slower than
//   the packed words when both were timed at the seed window's (1, 256).
//
// bloom_query_onehot (ports bloom_query_pallas_onehot, bloom.py:420, body
//   _query_kernel_onehot :405): member = all M positions set in the
//   unpacked 0/1 image (the TPU wrapper unpacks the packed signature before
//   the call, bloom.py:436-437; the port keeps that image as bytes).  The
//   TPU kernel's one-hot compare-and-sum is how a TPU gathers and is not
//   counted as work.  Bound by the bytes (4 in and 1 out an address, plus
//   the images) against the hash's operations up to the first clear bit;
//   at the seed path's shapes both sit far below one launch.  Design
//   (redesigned for Hopper): the hash is the parity form of h3_parity.cuh
//   (at most M * log2(seg_bits) popc an address, 36 for the paper's
//   geometry, against the xor-fold's M * addr_bits = 128 select-XOR
//   rounds), its column masks a __grid_constant__ parameter read from the
//   constant bank (compiled with the paper's geometry fixed, so the masks
//   are instruction operands); a block packs its lane's image once into
//   sig_bits / 32 words of shared memory (two 16-byte loads and a multiply
//   a word) and each thread tests one address against it, stopping at its
//   first clear bit.  The launch is short and latency-bound, so one address
//   a thread over ceil(N / 256) blocks a lane beat four a thread over a
//   grid of two blocks an SM when both were timed at the seed path's
//   (1, 168,335) shape.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "bloom_insert.cuh"
#include "h3_parity.cuh"

namespace {

constexpr int kThreads = 256;

// Nonzero flags of the four bytes of x, as bits 0-3.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  // bits 0, 8, 16, 24 -> 24, 25, 26, 27; every other product bit lands
  // below 24 at its own place, so nothing carries into them
  return ((x & 0x01010101u) * 0x01020408u) >> 24;
}

// Word w of the packed image: bytes 32w .. 32w + 31 of src, nonzero -> 1.
__device__ __forceinline__ uint32_t pack_word(const uint8_t* __restrict__ src, int w,
                                              bool aligned) {
  uint32_t word = 0u;
  if (aligned) {
    const uint4* v = reinterpret_cast<const uint4*>(src) + 2 * w;
    const uint4 lo = v[0], hi = v[1];
    const uint32_t q[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) word |= nonzero_bytes(q[i]) << (4 * i);
  } else {
    for (int i = 0; i < 32; ++i) word |= static_cast<uint32_t>(src[32 * w + i] != 0) << i;
  }
  return word;
}

// grid (ceil(N / kThreads), min(L, 65,535)): bits (L, sig_bits) 0/1
// bytes, addrs (L, N) -> out (L, N) 0/1 bytes.  kMany, taken only past
// 65,535 lanes or in a later pass of a spec hashed in passes, walks the
// lanes y, y + gridDim.y, ... in each block and, with and_out, ANDs into
// what out holds; without it a block answers its one lane in one pass, with
// no loop around it (the loop and the AND, built in everywhere, took
// registers and time at the paper's shapes: PERF.md, section 6).
template <int MC, int LOGC, bool kMany>
__global__ void __launch_bounds__(kThreads)
query_onehot_kernel(const uint8_t* __restrict__ bits, const uint32_t* __restrict__ addrs,
                    const __grid_constant__ h3p::Columns cols,
                    uint8_t* __restrict__ out, int L, int N, int M, int log_seg,
                    int sig_bits, int and_out) {
  extern __shared__ uint32_t image[];
  auto pack_image = [&](int lane) {
    const uint8_t* src = bits + static_cast<size_t>(lane) * sig_bits;
    const bool src_aligned = (reinterpret_cast<uintptr_t>(src) & 15u) == 0;
    for (int w = threadIdx.x; w < sig_bits / 32; w += blockDim.x) {
      image[w] = pack_word(src, w, src_aligned);
    }
    __syncthreads();
  };
  if constexpr (!kMany) {
    const int lane = blockIdx.y;
    pack_image(lane);
    const int i = blockIdx.x * blockDim.x + threadIdx.x;  // not live across the packing
    if (i >= N) return;
    const size_t k = static_cast<size_t>(lane) * N + i;
    out[k] = h3p::all_set<MC, LOGC>(cols, image, addrs[k], M, log_seg) ? 1 : 0;
  } else {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    for (int lane = blockIdx.y; lane < L; lane += gridDim.y) {
      if (lane != static_cast<int>(blockIdx.y)) __syncthreads();  // the last image is read
      pack_image(lane);
      if (i < N) {
        const size_t k = static_cast<size_t>(lane) * N + i;
        const bool prior = !and_out || out[k];
        out[k] = prior && h3p::all_set<MC, LOGC>(cols, image, addrs[k], M, log_seg) ? 1 : 0;
      }
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int MC, int LOGC>
int query_onehot_launch(const void* bits, const void* addrs, const void* columns,
                        void* out, int L, int N, int M, int log_seg, int m0, int and_out,
                        int sig_bits, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(sig_bits / 32) * sizeof(uint32_t);
  auto kernel = L > bins::kMaxLanesY || and_out ? query_onehot_kernel<MC, LOGC, true>
                                                : query_onehot_kernel<MC, LOGC, false>;
  if (int rc = set_smem(kernel, smem)) return rc;
  const dim3 grid((N + kThreads - 1) / kThreads, std::min(L, bins::kMaxLanesY));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(bits), static_cast<const uint32_t*>(addrs),
      h3p::load_columns(columns, M, log_seg, m0), static_cast<uint8_t*>(out), L, N, M,
      log_seg, sig_bits, and_out);
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

// k = 1 or 2 address lists; sig (L, NW) or null; out (k, L, NW).  columns
// holds the M segments from m0 on of one pass; or_out ORs in what out holds.
int bloom_insert_onehot_launch(const void* addrs_a, const void* mask_a,
                               const void* addrs_b, const void* mask_b, const void* sig,
                               const void* columns, void* out, int k, int L, int N_a,
                               int N_b, int M, int log_seg, int m0, int or_out, int NW,
                               void* stream) {
  const bins::Args args{addrs_a, addrs_b, static_cast<const uint8_t*>(mask_a),
                        static_cast<const uint8_t*>(mask_b), static_cast<const uint32_t*>(sig),
                        static_cast<uint32_t*>(out), L, N_a, N_b, 0, M, log_seg, 1, NW,
                        m0, or_out};
  return bins::launch_any<false>(args, k, columns, stream);
}

// columns holds the M segments from m0 on of one pass; and_out ANDs into
// what out holds.
int bloom_query_onehot_launch(const void* bits, const void* addrs,
                              const void* columns, void* out, int L, int N, int M,
                              int log_seg, int m0, int and_out, int sig_bits, void* stream) {
  auto launch = h3p::paper_geometry(M, log_seg, m0)
                    ? query_onehot_launch<h3p::kPaperM, h3p::kPaperLog>
                    : query_onehot_launch<0, 0>;
  return launch(bits, addrs, columns, out, L, N, M, log_seg, m0, and_out, sig_bits,
                static_cast<cudaStream_t>(stream));
}

// Registers, local memory (bytes a thread) and static shared memory of the
// loaded insert kernel, as cudaFuncGetAttributes reads them, into out[0..2]
// for the paper's geometry and out[3..5] for any other.
int bloom_insert_onehot_attributes(void* out) {
  int* o = static_cast<int*>(out);
  if (int rc = bins::build_attributes<h3p::kPaperM, h3p::kPaperLog, false>(o)) return rc;
  return bins::build_attributes<0, 0, false>(o + 3);
}

// The same of the loaded query kernel.
int bloom_query_onehot_attributes(void* out) {
  int* o = static_cast<int*>(out);
  if (int rc = attributes(query_onehot_kernel<h3p::kPaperM, h3p::kPaperLog, false>, o)) {
    return rc;
  }
  return attributes(query_onehot_kernel<0, 0, false>, o + 3);
}

}  // extern "C"
