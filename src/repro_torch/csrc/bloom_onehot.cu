// Seed one-hot Bloom-signature kernels of the LazyPIM simulator for Hopper
// (sm_90a): the CUDA counterparts of the two "seed" Pallas TPU kernels in
// src/repro/kernels/bloom/bloom.py that hash with the per-bit xor-fold H3
// (_h3_hash_block_xorfold, bloom.py:70) and keep the signature as an
// unpacked sig_bits-wide 0/1 image.  Addresses arrive as int32 bits and are
// read as uint32; packed words are uint32 here and int32 on the PyTorch
// side.  Both kernels are lane-batched (lanes on gridDim.y), launch on the
// caller's stream, allocate nothing and return cudaGetLastError().
//
// bloom_insert_onehot (ports bloom_insert_pallas_onehot, bloom.py:367, body
//   _insert_kernel_onehot :350): out |= pack(onehot(xorfold(addrs) where
//   mask)).  Bound by the operations of the xor-fold (N * M * addr_bits
//   rounds of a shift, an AND and a select-XOR) at the shapes the seed path
//   gives it; the bytes are 5 per address.  The TPU kernel expands each
//   position against a sig_bits-wide iota and ORs the hits, because a TPU
//   has no cheap scatter; here the one-hot image is a sig_bits-byte array in
//   shared memory (2-4 KB at the paper's geometries) into which each thread
//   stores a 1 at each of its M positions — plain stores of the same value,
//   so the order of the threads does not matter and the result is
//   deterministic.  Design: the (M, addr_bits) H3 matrix is staged in
//   shared memory (512 B for the paper's 4 x 32); a block takes a chunk of
//   addresses of one lane, exits at once when the mask clears all of them,
//   hashes one address a thread, then packs the image 32 bytes a word with
//   __ballot_sync and atomicOr-s the non-zero words into the lane's output
//   (which the caller filled with the incoming signature).
//
// bloom_query_onehot (ports bloom_query_pallas_onehot, bloom.py:420, body
//   _query_kernel_onehot :405): member = all M positions set in the
//   unpacked 0/1 image (the TPU wrapper unpacks the packed signature before
//   the call, bloom.py:436-437; the port keeps that image as bytes).
//   Bound by the xor-fold's operations as above; the TPU kernel's one-hot
//   compare-and-sum is how a TPU gathers and is not counted as work.
//   Design: the H3 matrix and the lane's image are staged in shared memory;
//   each thread hashes one address and gathers its M bytes from the staged
//   image, stopping at the first clear one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInsertChunk = 4 * kThreads;  // addresses per insert block

// Per-bit xor-fold H3 of one segment: XOR of row m of the H3 matrix over
// the set bits of the address, plus the segment's offset.
__device__ __forceinline__ uint32_t xorfold(const uint32_t* __restrict__ q,
                                            uint32_t a, int m, int addr_bits,
                                            uint32_t seg_bits) {
  const uint32_t* row = q + m * addr_bits;
  uint32_t h = 0u;
  for (int j = 0; j < addr_bits; ++j) {
    h ^= ((a >> j) & 1u) ? row[j] : 0u;
  }
  return h + static_cast<uint32_t>(m) * seg_bits;
}

__device__ __forceinline__ void stage_matrix(uint32_t* dst,
                                             const uint32_t* __restrict__ q,
                                             int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = q[i];
}

// grid (chunks, L): addrs (L, N), mask (L, N) or null, q (M, AB) ->
// out (L, NW), which holds the incoming signature and is OR-ed into.
__global__ void insert_onehot_kernel(const uint32_t* __restrict__ addrs,
                                     const uint8_t* __restrict__ mask,
                                     const uint32_t* __restrict__ q,
                                     uint32_t* __restrict__ out, int N, int M,
                                     int addr_bits, int sig_bits) {
  extern __shared__ uint32_t smem[];
  uint32_t* sq = smem;
  uint8_t* image = reinterpret_cast<uint8_t*>(smem + M * addr_bits);
  const int lane = blockIdx.y;
  const int i0 = blockIdx.x * kInsertChunk;
  const int i1 = min(i0 + kInsertChunk, N);
  const size_t row = static_cast<size_t>(lane) * N;
  int any = 0;
  for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    any |= mask == nullptr || mask[row + i] != 0;
  }
  if (!__syncthreads_or(any)) return;  // an all-false chunk inserts nothing
  stage_matrix(sq, q, M * addr_bits);
  uint32_t* image_words = reinterpret_cast<uint32_t*>(image);
  for (int i = threadIdx.x; i < sig_bits / 4; i += blockDim.x) image_words[i] = 0u;
  __syncthreads();
  const uint32_t seg_bits = static_cast<uint32_t>(sig_bits / M);
  for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    if (mask != nullptr && !mask[row + i]) continue;
    const uint32_t a = addrs[row + i];
    for (int m = 0; m < M; ++m) {
      const uint32_t p = xorfold(sq, a, m, addr_bits, seg_bits);
      if (p < static_cast<uint32_t>(sig_bits)) image[p] = 1;
    }
  }
  __syncthreads();
  const int t = threadIdx.x & 31;
  const int nw = sig_bits / 32;
  uint32_t* dst = out + static_cast<size_t>(lane) * nw;
  for (int w = threadIdx.x >> 5; w < nw; w += blockDim.x >> 5) {
    const uint32_t word = __ballot_sync(0xFFFFFFFFu, image[w * 32 + t] != 0);
    if (t == 0 && word) atomicOr(dst + w, word);
  }
}

// grid (ceil(N / kThreads), L): bits (L, sig_bits) 0/1 bytes, addrs (L, N),
// q (M, AB) -> out (L, N) 0/1 bytes.
__global__ void query_onehot_kernel(const uint8_t* __restrict__ bits,
                                    const uint32_t* __restrict__ addrs,
                                    const uint32_t* __restrict__ q,
                                    uint8_t* __restrict__ out, int N, int M,
                                    int addr_bits, int sig_bits) {
  extern __shared__ uint32_t smem[];
  uint32_t* sq = smem;
  uint8_t* image = reinterpret_cast<uint8_t*>(smem + M * addr_bits);
  const int lane = blockIdx.y;
  const uint8_t* src = bits + static_cast<size_t>(lane) * sig_bits;
  stage_matrix(sq, q, M * addr_bits);
  for (int i = threadIdx.x; i < sig_bits; i += blockDim.x) image[i] = src[i];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const size_t k = static_cast<size_t>(lane) * N + i;
  const uint32_t a = addrs[k];
  const uint32_t seg_bits = static_cast<uint32_t>(sig_bits / M);
  bool member = true;
  for (int m = 0; m < M && member; ++m) {
    const uint32_t p = xorfold(sq, a, m, addr_bits, seg_bits);
    member = p < static_cast<uint32_t>(sig_bits) && image[p] != 0;
  }
  out[k] = member ? 1 : 0;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

size_t smem_bytes(int M, int addr_bits, int sig_bits) {
  return static_cast<size_t>(M) * addr_bits * sizeof(uint32_t) +
         static_cast<size_t>(sig_bits);
}

}  // namespace

extern "C" {

int bloom_insert_onehot_launch(const void* addrs, const void* mask,
                               const void* q, void* out, int L, int N, int M,
                               int addr_bits, int sig_bits, void* stream) {
  const size_t smem = smem_bytes(M, addr_bits, sig_bits);
  if (int rc = set_smem(insert_onehot_kernel, smem)) return rc;
  const dim3 grid((N + kInsertChunk - 1) / kInsertChunk, L);
  insert_onehot_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(addrs), static_cast<const uint8_t*>(mask),
      static_cast<const uint32_t*>(q), static_cast<uint32_t*>(out), N, M,
      addr_bits, sig_bits);
  return static_cast<int>(cudaGetLastError());
}

int bloom_query_onehot_launch(const void* bits, const void* addrs, const void* q,
                              void* out, int L, int N, int M, int addr_bits,
                              int sig_bits, void* stream) {
  const size_t smem = smem_bytes(M, addr_bits, sig_bits);
  if (int rc = set_smem(query_onehot_kernel, smem)) return rc;
  const dim3 grid((N + kThreads - 1) / kThreads, L);
  query_onehot_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), static_cast<const uint32_t*>(addrs),
      static_cast<const uint32_t*>(q), static_cast<uint8_t*>(out), N, M,
      addr_bits, sig_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
