// The Bloom insert kernel shared by bloom.cu (bloom_insert, B2) and
// bloom_onehot.cu (bloom_insert_onehot, B8a): the M parity-form H3
// positions (h3_parity.cuh) of every item of a (list, lane) ORed into that
// lane's packed signature registers, for one list or two from one launch.
//
// Items are either id slots (int32 ids read as uint32, with a per-slot
// validity byte or none) or the set bits of a packed line bitmap (line
// ids below num_lines).  Item a goes to register a % R of the lane.
//
// Grid (C, min(L, 65,535), k): a cluster of C blocks (C <= 8, the portable
// cluster size) per (list, lane), list on z, lane on y; past 65,535 lanes a
// cluster walks the lanes y, y + gridDim.y, ... one after another, each
// with the same barriers.  The R x NW output words of
// a (list, lane) are split into C slices, block r's bank in shared memory
// holding slice r.  Each block zeroes its bank; after a cluster barrier
// every block ORs the positions of its share of the items into the bank
// that holds each word, its own or another block's through distributed
// shared memory (map_shared_rank; atomicOr, which is order-free, so the
// result is deterministic); after a second barrier each block stores its
// slice with a plain store, the incoming signature ORed in where one is
// given (and, in a later pass of a spec hashed in passes, the word the
// earlier passes stored).  So every output word is written exactly once a
// pass, the output needs no fill, and a block with no items still writes
// its zeros.  With C = 1 the block keeps the whole bank and the barriers
// are __syncthreads.  C is the larger of what the items ask and what the
// output needs: R x NW words over C blocks must fit a block's shared
// memory, so a large bank (16 registers of 2^16 bits) takes more blocks.
// Each block ORing into a bank of all R x NW words and then reading its
// slice from all C banks was slower when both were timed at the window's
// bank shape; so was one block a (list, lane) walking the whole bitmap.
//
// Id slots: one slot a thread, each block a contiguous span; invalid
// slots are never hashed (a hashed -1 would set real bits).  Bitmap words:
// a lane loads a granule of kGranule consecutive words, the granules
// dealt out so that neighbours land in different warps of different
// blocks (granule g goes to block g % C, then warp, then lane), and a warp
// walks its nonzero words (one ballot finds them, a shuffle hands each to
// every lane), each lane whose bit is set queueing its line in shared
// memory at its rank among the word's set bits; the warp hashes the queue
// 32 lines at a time, one a lane.  The lines a window sets are sparse
// (about one a nonzero word on the main paths), so hashing word by word,
// one line a lane, left most lanes idle; and a dense run of lines is
// spread over many warps by the granule order.

#pragma once

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "h3_parity.cuh"

namespace bins {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kGranule = 4;       // consecutive bitmap words a lane loads
constexpr int kQueue = 256;       // set lines a warp stages at a time
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kIdsPerBlock = 4 * kThreads;                // id slots a block
constexpr int kWordsPerBlock = kGranule * kThreads;       // bitmap words a block
constexpr int kMaxLanesY = 65535;                         // gridDim.y's limit
constexpr size_t kMaxSmem = 227 * 1024;                   // a block's shared memory

struct Args {
  const void* src_a;      // (L, n_a) int32 ids, or (L, n_a) uint32 bitmap words
  const void* src_b;      // the second list, or null
  const uint8_t* valid_a; // (L, n_a) validity bytes, or null: every slot (ids only)
  const uint8_t* valid_b;
  const uint32_t* sig;    // (L, NW) ORed into every image (R = 1), or null
  uint32_t* out;          // (k, L, R, NW)
  int L, n_a, n_b, num_lines, M, log_seg, R, NW;
  int m0;                 // the pass's first global segment (h3_parity.cuh)
  int or_out;             // OR the words out holds in (every pass but the first)
};

// The two halves of a cluster barrier (barrier.cluster), split so that
// work can run between them; every thread of the cluster executes each
// once, warp-uniformly.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int MC, int LOGC, bool kBitmap>
__global__ void __launch_bounds__(kThreads)
insert_kernel(const __grid_constant__ Args args, const __grid_constant__ h3p::Columns cols) {
  extern __shared__ uint32_t bank[];
  const int list = blockIdx.z;
  const int C = gridDim.x, rank = blockIdx.x;  // the cluster spans grid x
  const int n = list ? args.n_b : args.n_a;
  const int words = args.R * args.NW;
  const int per = (words + C - 1) / C;  // output words a block holds
  cg::cluster_group cluster = cg::this_cluster();
  for (int lane = blockIdx.y; lane < args.L; lane += gridDim.y) {
    // A thread zeroes and stores the same bank words, and no block ORs into
    // another's bank before that block's arrive below, so a lane's bank may
    // be zeroed as soon as this block has stored the last lane's.
    const size_t row = static_cast<size_t>(lane) * n;
    for (int i = threadIdx.x; i < per; i += blockDim.x) bank[i] = 0u;
    // Every bank must be zeroed before any block ORs into it.  A cluster
    // arrives here and waits only just before its first OR, so the barrier's
    // latency overlaps the first loads of the items.
    bool zeroed = C == 1;
    if (zeroed) {
      __syncthreads();
    } else {
      cluster_arrive();
    }
    auto await_zeroed = [&]() {
      if (!zeroed) cluster_wait();
      zeroed = true;
    };

    const uint32_t regs = static_cast<uint32_t>(args.R);
    auto insert = [&](uint32_t a) {
      const uint32_t off = regs == 1u ? 0u : (a % regs) * args.NW;
      h3p::positions<MC, LOGC>(cols, a, args.M, args.log_seg, [&](uint32_t p) {
        const uint32_t wi = off + (p >> 5);  // the output word, held by block wi / per
        uint32_t* slice = C == 1 ? bank : cluster.map_shared_rank(bank, wi / per);
        atomicOr(slice + wi % per, 1u << (p & 31u));
      });
    };
    if constexpr (kBitmap) {
      const uint32_t* src = static_cast<const uint32_t*>(list ? args.src_b : args.src_a) + row;
      const int t = threadIdx.x & 31, nwarps = blockDim.x >> 5;
      uint32_t* queue = bank + per + (threadIdx.x >> 5) * kQueue;  // this warp's lines
      int queued = 0;  // the same in every lane
      auto drain = [&]() {
        __syncwarp();
        for (int q = t; q < queued; q += 32) insert(queue[q]);
        __syncwarp();
        queued = 0;
      };
      const int granules = (n + kGranule - 1) / kGranule;
      const int lane_stride = C * nwarps;  // between neighbouring lanes' granules
      for (int base = rank + C * (threadIdx.x >> 5); base < granules;
           base += lane_stride * 32) {
        const int w0 = (base + lane_stride * t) * kGranule;  // this lane's first word
        uint32_t v[kGranule];  // all the granule's loads in flight at once
#pragma unroll
        for (int u = 0; u < kGranule; ++u) {
          const int w = w0 + u;
          v[u] = w < n ? src[w] : 0u;
          const int rest = args.num_lines - w * 32;  // lines of word w below num_lines
          if (rest < 32) v[u] &= rest <= 0 ? 0u : (1u << rest) - 1u;
        }
        await_zeroed();
#pragma unroll
        for (int u = 0; u < kGranule; ++u) {
          // Each nonzero word of the warp in turn: every lane whose bit is
          // set queues its line at its rank among the word's set bits.
          for (uint32_t pending = __ballot_sync(0xFFFFFFFFu, v[u] != 0u); pending;
               pending &= pending - 1u) {
            const int i = __ffs(pending) - 1;
            const uint32_t word = __shfl_sync(0xFFFFFFFFu, v[u], i);
            if ((word >> t) & 1u) {
              const int w = (base + lane_stride * i) * kGranule + u;
              queue[queued + __popc(word & ((1u << t) - 1u))] =
                  static_cast<uint32_t>(w) * 32u + static_cast<uint32_t>(t);
            }
            queued += __popc(word);
            if (queued > kQueue - 32) drain();
          }
        }
      }
      await_zeroed();  // a warp that had no granule waits here
      drain();
    } else {
      await_zeroed();
      const int span = (n + C - 1) / C;
      const int begin = rank * span, end = min(begin + span, n);
      const int32_t* ids = static_cast<const int32_t*>(list ? args.src_b : args.src_a) + row;
      const uint8_t* valid = list ? args.valid_b : args.valid_a;
      if (valid != nullptr) valid += row;
      for (int j = begin + threadIdx.x; j < end; j += blockDim.x) {
        if (valid != nullptr && !valid[j]) continue;
        insert(static_cast<uint32_t>(ids[j]));
      }
    }

    // Every position is in: store this block's slice of the output.
    if (C > 1) cluster.sync(); else __syncthreads();
    uint32_t* dst = args.out + (static_cast<size_t>(list) * args.L + lane) * words;
    const uint32_t* sig =
        args.sig == nullptr ? nullptr : args.sig + static_cast<size_t>(lane) * args.NW;
    const int i0 = rank * per, held = min(per, words - i0);
    for (int i = threadIdx.x; i < held; i += blockDim.x) {
      dst[i0 + i] = bank[i] | (sig != nullptr ? sig[i0 + i] : 0u) |
                    (args.or_out ? dst[i0 + i] : 0u);
    }
  }
}

// Shared memory a block stages besides its bank: the bitmap form's line
// queues.
inline size_t queue_bytes(bool bitmap) {
  return bitmap ? static_cast<size_t>(kThreads / 32) * kQueue * sizeof(uint32_t) : 0;
}

// Cluster size for (list, lane)s of n items and `words` output words: one
// block per kIdsPerBlock slots or kWordsPerBlock words, at most
// kMaxCluster, and at least enough blocks that each one's slice of the
// output fits its shared memory (more than kMaxCluster if even that does
// not suffice; the launch then refuses).
inline int cluster_size(int n, size_t words, bool bitmap) {
  const int per = bitmap ? kWordsPerBlock : kIdsPerBlock;
  const size_t room = (kMaxSmem - queue_bytes(bitmap)) / sizeof(uint32_t);
  const int need = static_cast<int>((words + room - 1) / room);
  return std::max({1, std::min((n + per - 1) / per, kMaxCluster), need});
}

template <int MC, int LOGC, bool kBitmap>
int launch(const Args& args, int k, const void* columns, cudaStream_t stream) {
  auto kernel = insert_kernel<MC, LOGC, kBitmap>;
  const size_t words = static_cast<size_t>(args.R) * args.NW;
  const int C = cluster_size(std::max(args.n_a, args.n_b), words, kBitmap);
  if (C > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (words + C - 1) / C * sizeof(uint32_t) + queue_bytes(kBitmap);
  if (cudaError_t rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem))) {
    return static_cast<int>(rc);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(C, std::min(args.L, kMaxLanesY), k);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const h3p::Columns cols = h3p::load_columns(columns, args.M, args.log_seg, args.m0);
  void* params[] = {const_cast<Args*>(&args), const_cast<h3p::Columns*>(&cols)};
  if (cudaError_t rc = cudaLaunchKernelExC(&config, reinterpret_cast<const void*>(kernel),
                                           params)) {
    return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launcher of one form, the paper's geometry fixed or any.
template <bool kBitmap>
int launch_any(const Args& args, int k, const void* columns, void* stream) {
  auto fn = h3p::paper_geometry(args.M, args.log_seg, args.m0)
                ? launch<h3p::kPaperM, h3p::kPaperLog, kBitmap>
                : launch<0, 0, kBitmap>;
  return fn(args, k, columns, static_cast<cudaStream_t>(stream));
}

// Registers, local memory (bytes a thread) and static shared memory of one
// build, as cudaFuncGetAttributes reads them, into out[0..2].
template <int MC, int LOGC, bool kBitmap>
int build_attributes(int* out) {
  cudaFuncAttributes attr;
  if (cudaError_t rc = cudaFuncGetAttributes(&attr, insert_kernel<MC, LOGC, kBitmap>)) {
    return static_cast<int>(rc);
  }
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}

}  // namespace bins
