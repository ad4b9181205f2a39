// Flash attention (GQA, causal / sliding-window) for Hopper (sm_90a).
//
// flash_attention (ports flash_attention_pallas, src/repro/kernels/
//   flash_attention/flash_attention.py:82, pallas_call :118, body
//   _fa_kernel :35): q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D), both
//   float32 or both bfloat16, out (B, Sq, Hq, D) in q's dtype:
//     s[i, j] = (q_i . k_j) * D**-0.5, masked to -FLT_MAX where
//       j >= Sk, or (causal) j > i, or (causal, window > 0) j <= i - window
//     out_i = sum_j softmax_j(s[i, :]) v_j          (0 for a row with no key)
//   with the online softmax of the TPU kernel: running row max m, row sum l
//   and float32 accumulator acc over KV tiles, alpha = exp(m_prev - m_new)
//   (0 while m_prev is still -FLT_MAX), and out = acc / max(l, 1e-30).
//   Query head h reads kv head h / (Hq / Hkv); K and V are never repeated.
//
// What bounds it: at the serving path's shape (4 x 4,096 tokens, 32 query
// heads, 8 kv heads, D = 128, causal) the two products do ~5.5e11 useful
// flops on ~335 MB of inputs and output, so the tensor cores and not the
// memory set the floor (0.56 ms at 989 TFLOP/s in bf16).  The TPU kernel
// walks a (batch*head, q tile, k tile) grid with the running state in VMEM
// scratch across the sequential k axis, and computes every k tile, masked
// or not.  Here blocks run in parallel in no order, so one block owns one
// (batch*head, 64-row query tile) and loops over the KV tiles itself:
// - the loop starts and stops at the causal (and window) edge instead of
//   computing fully masked tiles, about halving the work of a causal call;
// - in bfloat16 both products run on the tensor cores (WMMA 16x16x16,
//   float32 accumulate): each of 4 warps owns 16 query rows, S = Q K^T goes
//   to shared memory, the warp's rows are softmaxed there in float32 and
//   the probabilities rounded to bfloat16 in place for the P V product
//   (the TPU kernel keeps P in float32: the one rounding site it lacks);
// - in float32 the products are exact float32 FMA loops on the CUDA cores
//   (no TF32), so the kernel equals the float32 plain version up to the
//   order of its sums;
// - K and V tiles (64 keys) are staged in shared memory with 16-byte loads,
//   rows past Sk zero-filled and masked, so Sq and Sk need no padding and a
//   non-causal call with a ragged Sk is masked, not refused;
// - heavier query tiles (larger i under a causal mask) are scheduled first.
// The output accumulator lives in shared memory (float32), so the alpha
// rescale is a plain row loop.  Not yet done (later perf work): cp.async /
// TMA double buffering of the K and V tiles, wgmma, register-resident
// accumulators, warp specialisation.
//
// Every launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cfloat>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per KV tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;  // query rows per warp (one WMMA row tile)
constexpr float kNegInf = -FLT_MAX;  // jnp.finfo(float32).min, as the reference
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90
static_assert(kBQ == kBK, "load_tile stages Q tiles and K/V tiles alike");

// Shared-memory layout (element strides and byte offsets) for head dim D.
// bfloat16 rows are padded by 8 elements and float32 rows by 4 (16 bytes,
// against bank conflicts; WMMA needs 32-byte aligned tiles and strides that
// are multiples of 16 bytes); the float32 K tile is padded by 1 so that 32
// lanes reading 32 different keys hit 32 banks.  In bfloat16 the P tile
// (bf16) is written over the S tile (float32) row by row: row r of P starts
// where row r of S does, with twice the element stride.
struct Geo {
  int ldq, ldk, ldv, lds, ldo;
  size_t off_k, off_v, off_s, off_o, off_m, off_l, bytes;
};

__host__ __device__ inline size_t round32(size_t n) { return (n + 31) & ~size_t(31); }

__host__ __device__ inline Geo geometry(int D, bool bf16) {
  Geo g;
  const size_t es = bf16 ? 2 : 4;
  g.ldq = bf16 ? D + 8 : D;
  g.ldk = bf16 ? D + 8 : D + 1;
  g.ldv = bf16 ? D + 8 : D;
  g.lds = kBK + 4;
  g.ldo = bf16 ? D + 4 : D;
  size_t off = round32(kBQ * g.ldq * es);
  g.off_k = off;
  off += round32(kBK * g.ldk * es);
  g.off_v = off;
  off += round32(kBK * g.ldv * es);
  g.off_s = off;
  off += round32(kBQ * g.lds * 4);
  g.off_o = off;
  off += round32(kBQ * static_cast<size_t>(g.ldo) * 4);
  g.off_m = off;
  off += round32(kBQ * 4);
  g.off_l = off;
  off += round32(kBQ * 4);
  g.bytes = off;
  return g;
}

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage rows [row0, row0 + 64) of a (rows, D) slice with row stride `stride`
// (elements) into shared memory with row stride `ld`; rows >= limit are
// zero.  16-byte global loads (D * sizeof(T) is a multiple of 16 and every
// row start is 16-byte aligned: the wrapper checks both).
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* __restrict__ src,
                                          size_t stride, int row0, int limit, int D) {
  constexpr int E = 16 / sizeof(T);
  const int per_row = D / E;
  const bool vec_store = (ld * sizeof(T)) % 16 == 0;
  for (int idx = threadIdx.x; idx < kBK * per_row; idx += kThreads) {
    const int r = idx / per_row;
    const int c = (idx % per_row) * E;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit) {
      raw = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * stride + c);
    }
    T* d = dst + r * ld + c;
    if (vec_store) {
      *reinterpret_cast<uint4*>(d) = raw;
    } else {
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < E; ++e) d[e] = v[e];
    }
  }
}

// S rows [r0, r0 + 16) = Q K^T for this warp (unscaled), float32.
__device__ __forceinline__ void warp_scores(const __nv_bfloat16* Qs, const __nv_bfloat16* Ks,
                                            float* Ss, const Geo& g, int r0, int D) {
  using namespace nvcuda;
#pragma unroll
  for (int nn = 0; nn < kBK / 16; ++nn) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::fill_fragment(c, 0.0f);
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, Qs + r0 * g.ldq + kk * 16, g.ldq);
      wmma::load_matrix_sync(b, Ks + nn * 16 * g.ldk + kk * 16, g.ldk);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(Ss + r0 * g.lds + nn * 16, c, g.lds, wmma::mem_row_major);
  }
}

__device__ __forceinline__ void warp_scores(const float* Qs, const float* Ks, float* Ss,
                                            const Geo& g, int r0, int D) {
  const int lane = threadIdx.x & 31;
  for (int r = r0; r < r0 + kRows; ++r) {
    const float* qr = Qs + r * g.ldq;
    for (int c = lane; c < kBK; c += 32) {
      const float* kr = Ks + c * g.ldk;
      float acc = 0.0f;
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
      Ss[r * g.lds + c] = acc;
    }
  }
}

// O rows [r0, r0 + 16) += P V for this warp.
__device__ __forceinline__ void warp_pv(float* Ss, const __nv_bfloat16* Vs, float* Os,
                                        const Geo& g, int r0, int D) {
  using namespace nvcuda;
  const __nv_bfloat16* Ps = reinterpret_cast<const __nv_bfloat16*>(Ss);
  const int ldp = 2 * g.lds;
  for (int dd = 0; dd < D / 16; ++dd) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::load_matrix_sync(c, Os + r0 * g.ldo + dd * 16, g.ldo, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, Ps + r0 * ldp + kk * 16, ldp);
      wmma::load_matrix_sync(b, Vs + kk * 16 * g.ldv + dd * 16, g.ldv);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(Os + r0 * g.ldo + dd * 16, c, g.ldo, wmma::mem_row_major);
  }
}

__device__ __forceinline__ void warp_pv(float* Ss, const float* Vs, float* Os, const Geo& g,
                                        int r0, int D) {
  const int lane = threadIdx.x & 31;
  for (int r = r0; r < r0 + kRows; ++r) {
    const float* pr = Ss + r * g.lds;
    for (int d = lane; d < D; d += 32) {
      float acc = Os[r * g.ldo + d];
      for (int c = 0; c < kBK; ++c) acc = fmaf(pr[c], Vs[c * g.ldv + d], acc);
      Os[r * g.ldo + d] = acc;
    }
  }
}

// Write one probability: bf16 over the S row (read before, see geometry),
// float32 in place.
__device__ __forceinline__ void put_p(float* Ss, const Geo& g, int r, int c, float p, bool bf16) {
  if (bf16) {
    reinterpret_cast<__nv_bfloat16*>(Ss)[r * 2 * g.lds + c] = __float2bfloat16(p);
  } else {
    Ss[r * g.lds + c] = p;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
                       int Hq, int Hkv, int D, float scale, int causal, int window) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const Geo g = geometry(D, kBf16);
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + g.off_k);
  T* Vs = reinterpret_cast<T*>(smem + g.off_v);
  float* Ss = reinterpret_cast<float*>(smem + g.off_s);
  float* Os = reinterpret_cast<float*>(smem + g.off_o);
  float* row_m = reinterpret_cast<float*>(smem + g.off_m);
  float* row_l = reinterpret_cast<float*>(smem + g.off_l);

  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * kRows;
  const size_t q_stride = static_cast<size_t>(Hq) * D;
  const size_t k_stride = static_cast<size_t>(Hkv) * D;
  const T* qb = q + static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * Sk * k_stride + static_cast<size_t>(hk) * D;
  const T* vb = v + static_cast<size_t>(b) * Sk * k_stride + static_cast<size_t>(hk) * D;
  T* ob = out + static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * D;

  load_tile<T>(Qs, g.ldq, qb, q_stride, q0, Sq, D);
  for (int i = threadIdx.x; i < kBQ * g.ldo; i += kThreads) Os[i] = 0.0f;
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    row_m[i] = kNegInf;
    row_l[i] = 0.0f;
  }

  // KV tiles that hold at least one unmasked key for some row of the tile.
  int k_begin = 0, k_end = Sk;
  if (causal) {
    k_end = min(Sk, q0 + kBQ);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > k_begin ? (k_end + kBK - 1) / kBK : t_begin;
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    load_tile<T>(Ks, g.ldk, kb, k_stride, k0, Sk, D);
    load_tile<T>(Vs, g.ldv, vb, k_stride, k0, Sk, D);
    __syncthreads();
    warp_scores(Qs, Ks, Ss, g, r0, D);
    __syncwarp();
    for (int r = r0; r < r0 + kRows; ++r) {
      const int qp = q0 + r;
      float s[2];
      bool ok[2];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        const int kp = k0 + c;
        bool m = kp < Sk;
        if (causal) {
          m = m && kp <= qp;
          if (window > 0) m = m && kp > qp - window;
        }
        ok[j] = m;
        s[j] = m ? Ss[r * g.lds + c] * scale : kNegInf;
        mx = fmaxf(mx, s[j]);
      }
      mx = warp_max(mx);
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new == kNegInf ? 0.0f : m_new;
      float p[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) p[j] = ok[j] ? expf(s[j] - m_safe) : 0.0f;
      const float sum = warp_sum(p[0] + p[1]);
      const float alpha = m_prev == kNegInf ? 0.0f : expf(m_prev - m_safe);
      __syncwarp();  // every lane has read its S values before P overwrites them
#pragma unroll
      for (int j = 0; j < 2; ++j) put_p(Ss, g, r, lane + 32 * j, p[j], kBf16);
      for (int d = lane; d < D; d += 32) Os[r * g.ldo + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + sum;
      }
    }
    __syncwarp();
    warp_pv(Ss, Vs, Os, g, r0, D);
    __syncthreads();  // the next tile overwrites K and V
  }

  __syncwarp();
  for (int r = r0; r < r0 + kRows; ++r) {
    if (q0 + r >= Sq) break;
    const float l = fmaxf(row_l[r], 1e-30f);
    T* orow = ob + static_cast<size_t>(q0 + r) * q_stride;
    for (int d = lane; d < D; d += 32) store_as(orow + d, Os[r * g.ldo + d] / l);
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                 int Sk, int Hq, int Hkv, int D, float scale, int causal, int window,
                 cudaStream_t stream) {
  const Geo g = geometry(D, sizeof(T) == 2);
  if (g.bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int n_q = (Sq + kBQ - 1) / kBQ;
  if (B == 0 || Hq == 0 || n_q == 0) return 0;
  if (static_cast<long long>(B) * Hq > INT_MAX || n_q > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);  // beyond the grid's x / y limits
  }
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(g.bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * Hq, n_q);
  flash_attention_kernel<T><<<grid, kThreads, g.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, Hq, Hkv, D, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (B, Sq, Hq, D), k / v (B, Sk, Hkv, D), out (B, Sq, Hq, D), contiguous,
// 16-byte aligned, D a multiple of 16, Hq a multiple of Hkv.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int B,
                           int Sq, int Sk, int Hq, int Hkv, int D, float scale, int causal,
                           int window, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 16 != 0 || Hkv <= 0 || Hq % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return launch_typed<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, scale, causal, window, s);
  }
  if (dtype == 1) {
    return launch_typed<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, scale, causal,
                                       window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
