// Flash attention (GQA, causal / sliding-window) for Hopper (sm_90a): the
// general route, every float32 call and bfloat16 at the head dims the sm90
// kernel does not take.
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
//   D is a multiple of 16, up to 320 in bfloat16 and 208 in float32.
//
// What bounds it: at the prefill path's shape (4 x 4,096 tokens, 32 query
// heads, 8 kv heads, D = 128, causal) the two products do ~5.5e11 useful
// flops on ~335 MB (bf16) of inputs and output: in bfloat16 the tensor
// cores set the floor (0.56 ms at 989 TFLOP/s), in float32 the CUDA cores'
// FFMA rate (8.2 ms at 67 TFLOP/s: this route computes float32 exactly, no
// TF32).  The TPU kernel walks a (batch*head, q tile, k tile) grid with the
// running state in VMEM scratch across the sequential k axis.  Here blocks
// run in parallel in no order, so one block owns one (batch*head, query
// tile) and loops over the KV tiles itself, from the first to the last
// tile that holds an unmasked key for some row of the block (the causal /
// window edge: fully masked tiles are never computed), the heaviest query
// tiles scheduled first.  K and V tiles go through a 2-stage cp.async
// ring: tile t + 1 is in flight while tile t is computed (rows past Sk
// arrive zero-filled and are masked, so nothing is padded).  Neither the
// scores nor the accumulator make a round trip through shared memory.
//
// bfloat16 (flash_attention_bf16_kernel<NC, BK, MT>): 4 warps, each owning
// MT m tiles of 16 query rows (a block holds 64 MT rows).
// - Both products are mma.sync.m16n8k16 (bf16 in, float32 accumulate)
//   through inline PTX; Q and K fragments come from shared memory by
//   ldmatrix, V's by ldmatrix.trans, rows padded by 16 bytes so the eight
//   row addresses of each 8x8 matrix hit distinct banks; each K and V
//   fragment feeds the warp's MT m tiles.
// - S (16 x BK an m tile) stays in registers in the C-fragment layout: a
//   thread holds two rows, so a row's max takes two shuffles within its
//   quad; the per-thread share of the row sum is reduced once, at the end.
//   The softmax runs in base 2 (scores scaled by D**-0.5 log2 e, one ex2 an
//   element); masks are computed only in the tiles that straddle Sk, the
//   diagonal or the window edge of the m tile's rows, and O is rescaled
//   only when some row of the warp has a new max.
// - The S C-fragments become the A fragments of the PV product in registers
//   (the C layout of two adjacent n8 tiles is the A layout of one k16
//   slice), so P never touches shared memory.  P goes in as two bf16 parts,
//   hi = bf16(P) and lo = bf16(P - hi), two products into the same O: hi +
//   lo holds P to ~2^-17, so PV keeps the TPU kernel's float32 P (a single
//   bf16 P, 2^-9, strays past the bf16 tolerance where V has channels far
//   above the output row's RMS).
// - O (16 MT x D a warp, float32) stays in registers for the whole KV loop.
// - Head dims come in bands, each a template instance that unrolls over its
//   largest D (a 16-column chunk past the call's D is skipped): D <= 128
//   with MT = 2 and BK = 64 keys a tile, <= 256 and <= 320 with MT = 1 and
//   BK = 32, so O and S together stay within 255 registers a thread
//   (flash_attention_general_attributes reports each band's registers and
//   local memory; none spills).
//
// float32 (flash_attention_f32_kernel<NI, BK>): 256 threads as a 16 x 16
// grid; thread (ry, kx) owns query rows ry + 16 i (i < 4) of the block's 64.
// - S = Q K^T register-tiled SGEMM-style: the thread owns keys kx + 16 j
//   (j < BK / 16) of its 4 rows; Q and K rows are read from shared memory
//   as float4 along D, so 4 + BK / 16 16-byte loads feed BK FMAs.  Each dot
//   product sums d = 0 .. D - 1 in order with exact float32 FMA (and expf,
//   not a fast exponential): the kernel equals the float32 plain version up
//   to the order of its sums.
// - A row's 16 key-owners are one half-warp: the row max takes four
//   shuffles; the per-thread share of the row sum is reduced at the end.
// - P goes to shared memory key-major, each thread's 4 rows side by side,
//   so the PV product reads them as one float4 a key; only the half-warp
//   that owns those rows reads them, so a __syncwarp orders the handoff.
// - O += P V register-tiled the same way: the thread owns its 4 rows x the
//   float4 columns kx + 16 n (n < NI) of O, V rows read as float4.
// - Bands: NI = ceil(D / 64) in {1, 2, 4}; BK = 64 up to D = 64 and 32
//   above, so that Q, the K / V ring and P fit a block's shared memory
//   twice up to D = 128 (once up to 208).
//
// Every launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cfloat>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;              // query rows a float32 block (64 MT a bf16 one)
constexpr float kNegInf = -FLT_MAX;  // jnp.finfo(float32).min, as the reference
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr int kMaxDBf16 = 320;
constexpr int kMaxDF32 = 208;
constexpr int kBf16Threads = 128;
constexpr int kKX = 16;                // float32: threads that share a row group
constexpr int kF32Threads = 16 * kKX;  // float32: 16 row groups of 4 rows

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b, one m16n8k16 bf16 product with float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, the first in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// What pack_bf16(lo, hi) == packed rounded away, itself rounded to bf16.
__device__ __forceinline__ uint32_t pack_bf16_rest(float lo, float hi, uint32_t packed) {
  const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed));
  return pack_bf16(lo - r.x, hi - r.y);
}

// Stage rows [row0, row0 + rows) of a (limit, D) slice with row stride
// `stride` (elements) into shared memory with row stride `ld`, 16 bytes a
// cp.async; rows >= limit are zero-filled (nothing is read for them).
template <typename T>
__device__ __forceinline__ void load_tile_async(T* dst, int ld, const T* __restrict__ src,
                                                size_t stride, int row0, int rows, int limit,
                                                int D, int nthreads) {
  constexpr int E = 16 / sizeof(T);
  const int per_row = D / E;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += nthreads) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * E;
    const bool ok = row0 + r < limit;
    cp_async16(dst + r * ld + c, src + static_cast<size_t>(ok ? row0 + r : 0) * stride + c, ok);
  }
}

// Where a block's query tile starts (heaviest tiles first) and the KV tiles
// [t_begin, t_end) holding at least one unmasked key for some row of it.
struct Span {
  int q0, t_begin, t_end;
};

__device__ __forceinline__ Span block_span(int BQ, int Sk, int BK, int causal, int window) {
  Span s;
  s.q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  int k_begin = 0, k_end = Sk;
  if (causal) {
    k_end = min(Sk, s.q0 + BQ);
    if (window > 0) k_begin = max(0, s.q0 - window + 1);
  }
  s.t_begin = k_begin / BK;
  s.t_end = k_end > k_begin ? (k_end + BK - 1) / BK : s.t_begin;
  return s;
}

__device__ __forceinline__ bool key_ok(int kp, int qp, int Sk, int causal, int window) {
  bool ok = kp < Sk;
  if (causal) {
    ok = ok && kp <= qp;
    if (window > 0) ok = ok && kp > qp - window;
  }
  return ok;
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync, S / P / O in registers
// ---------------------------------------------------------------------------

template <int BK, int MT>
__host__ __device__ constexpr size_t bf16_smem_bytes(int D) {
  return static_cast<size_t>(64 * MT + 4 * BK) * (D + 8) * 2;  // Q, 2 x K, 2 x V
}

// 2^x (MUFU.EX2; 0 for x = -FLT_MAX).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// NC: 16-column chunks of D unrolled (the band's largest D / 16); BK: keys a
// tile; MT: 16-row m tiles a warp (a block holds 64 MT query rows).
template <int NC, int BK, int MT>
__global__ void __launch_bounds__(kBf16Threads)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                            int Sq, int Sk, int Hq, int Hkv, int D, float scale, int causal,
                            int window) {
  constexpr int NT = BK / 8;  // n8 tiles of S an m tile
  constexpr int BQ = 64 * MT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = D + 8;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * ld;      // 2 stages of BK rows
  __nv_bfloat16* Vs = Ks + 2 * BK * ld;  // 2 stages of BK rows
  const int nc = D / 16;
  // the softmax runs in base 2: s * scale * log2(e), so p = 2^(x - m)
  const float scale2 = scale * 1.4426950408889634f;

  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const Span sp = block_span(BQ, Sk, BK, causal, window);
  const int q0 = sp.q0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // the C fragment's row group and column pair
  const int r0 = warp * 16 * MT;           // the warp's first row in the block
  const size_t q_stride = static_cast<size_t>(Hq) * D;
  const size_t k_stride = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * D;
  const __nv_bfloat16* kb =
      k + static_cast<size_t>(b) * Sk * k_stride + static_cast<size_t>(hk) * D;
  const __nv_bfloat16* vb =
      v + static_cast<size_t>(b) * Sk * k_stride + static_cast<size_t>(hk) * D;

  load_tile_async(Qs, ld, qb, q_stride, q0, BQ, Sq, D, kBf16Threads);
  if (sp.t_begin < sp.t_end) {
    load_tile_async(Ks, ld, kb, k_stride, sp.t_begin * BK, BK, Sk, D, kBf16Threads);
    load_tile_async(Vs, ld, vb, k_stride, sp.t_begin * BK, BK, Sk, D, kBf16Threads);
  }
  cp_async_commit();

  float o[MT][2 * NC][4];
  float m_run[MT][2], l_part[MT][2];  // rows g and g + 8 of each m tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < 2 * NC; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.0f;
    m_run[mt][0] = m_run[mt][1] = kNegInf;
    l_part[mt][0] = l_part[mt][1] = 0.0f;
  }

  for (int t = sp.t_begin; t < sp.t_end; ++t) {
    const int stage = (t - sp.t_begin) & 1;
    if (t + 1 < sp.t_end) {
      const int nxt = stage ^ 1;
      load_tile_async(Ks + nxt * BK * ld, ld, kb, k_stride, (t + 1) * BK, BK, Sk, D,
                      kBf16Threads);
      load_tile_async(Vs + nxt * BK * ld, ld, vb, k_stride, (t + 1) * BK, BK, Sk, D,
                      kBf16Threads);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and Q) have landed for this thread...
    __syncthreads();     // ...and for every thread
    const __nv_bfloat16* Kt = Ks + stage * BK * ld;
    const __nv_bfloat16* Vt = Vs + stage * BK * ld;
    const int k0 = t * BK;

    // S = Q K^T for the warp's 16 MT rows; each K fragment feeds MT products
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < NT; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.0f;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < nc) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          ldmatrix_x4(a[mt], Qs + (r0 + 16 * mt + (lane & 15)) * ld + c * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, Kt + (j * 8 + (lane & 7) + (lane >> 4) * 8) * ld + c * 16 +
                              ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][j], a[mt], bk[0], bk[1]);
            mma_bf16(s[mt][j + 1], a[mt], bk[2], bk[3]);
          }
        }
      }
    }

    // online softmax in registers, base 2
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int qlo = q0 + r0 + 16 * mt;  // the m tile's first query position
      const bool masked = k0 + BK > Sk ||
                          (causal && (k0 + BK - 1 > qlo ||
                                      (window > 0 && k0 <= qlo + 15 - window)));
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][j][e] * scale2;
          if (masked) {
            const int kp = k0 + j * 8 + 2 * tq + (e & 1);
            x = key_ok(kp, qlo + g + (e >> 1) * 8, Sk, causal, window) ? x : kNegInf;
          }
          s[mt][j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float m_safe[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[mt][r], mx[r]);
        m_safe[r] = m_new == kNegInf ? 0.0f : m_new;
        alpha[r] = m_run[mt][r] == kNegInf ? 0.0f : ex2(m_run[mt][r] - m_safe[r]);
        m_run[mt][r] = m_new;
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(s[mt][j][e] - m_safe[e >> 1]);  // 0 where masked
          s[mt][j][e] = p;
          sum[e >> 1] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_part[mt][r] = l_part[mt][r] * alpha[r] + sum[r];
      // a factor of 1 leaves O as it is: skip the pass when no row's max moved
      if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
        for (int n = 0; n < 2 * NC; ++n) {
          o[mt][n][0] *= alpha[0];
          o[mt][n][1] *= alpha[0];
          o[mt][n][2] *= alpha[1];
          o[mt][n][3] *= alpha[1];
        }
      }
    }

    // O += P V: P's A fragments straight from the S C fragments; each V
    // fragment feeds MT products
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4], ar[MT][4];  // bf16(P) and bf16(P - bf16(P))
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float x[8] = {s[mt][2 * kk][0], s[mt][2 * kk][1], s[mt][2 * kk][2],
                            s[mt][2 * kk][3], s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1],
                            s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[mt][i] = pack_bf16(x[2 * i], x[2 * i + 1]);
          ar[mt][i] = pack_bf16_rest(x[2 * i], x[2 * i + 1], a[mt][i]);
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < nc) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                                    c * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][2 * c], ar[mt], bv[0], bv[1]);
            mma_bf16(o[mt][2 * c], a[mt], bv[0], bv[1]);
            mma_bf16(o[mt][2 * c + 1], ar[mt], bv[2], bv[3]);
            mma_bf16(o[mt][2 * c + 1], a[mt], bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_part[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l = fmaxf(l, 1e-30f);
      const int qp = q0 + r0 + 16 * mt + g + r * 8;
      if (qp >= Sq) continue;
      __nv_bfloat16* orow = out + static_cast<size_t>(b) * Sq * q_stride +
                            static_cast<size_t>(qp) * q_stride + static_cast<size_t>(h) * D;
#pragma unroll
      for (int n = 0; n < 2 * NC; ++n) {
        if (n < 2 * nc) {
          *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tq) =
              __floats2bfloat162_rn(o[mt][n][2 * r] / l, o[mt][n][2 * r + 1] / l);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: register-tiled exact FFMA
// ---------------------------------------------------------------------------

// o += p w, element by element.
__device__ __forceinline__ void fma4(float4& o, float p, const float4& w) {
  o.x = fmaf(p, w.x, o.x);
  o.y = fmaf(p, w.y, o.y);
  o.z = fmaf(p, w.z, o.z);
  o.w = fmaf(p, w.w, o.w);
}

template <int BK>
__host__ __device__ constexpr size_t f32_smem_bytes(int D) {
  // Q, 2 x K, 2 x V (rows of D + 4 floats), P (BK x (64 + 4) floats)
  return (static_cast<size_t>(kBQ + 4 * BK) * (D + 4) + static_cast<size_t>(BK) * (kBQ + 4)) *
         4;
}

// NI: float4 columns of O a thread (the band's largest D / 64, rounded
// up); BK: keys a tile.
template <int NI, int BK>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int Sq, int Sk,
                           int Hq, int Hkv, int D, float scale, int causal, int window) {
  constexpr int JK = BK / kKX;   // keys a thread in S
  constexpr int LDP = kBQ + 4;   // P row stride (one row a key)
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = D + 4;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBQ * ld;      // 2 stages of BK rows
  float* Vs = Ks + 2 * BK * ld;   // 2 stages of BK rows
  float* Ps = Vs + 2 * BK * ld;   // BK x LDP

  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const Span sp = block_span(kBQ, Sk, BK, causal, window);
  const int q0 = sp.q0;
  const int ry = threadIdx.x / kKX;  // rows ry + 16 i
  const int kx = threadIdx.x % kKX;  // keys kx + 16 j in S; float4 columns kx + 16 n in O
  const int nq4 = D / 4;
  const size_t q_stride = static_cast<size_t>(Hq) * D;
  const size_t k_stride = static_cast<size_t>(Hkv) * D;
  const float* qb = q + static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * D;
  const float* kb = k + static_cast<size_t>(b) * Sk * k_stride + static_cast<size_t>(hk) * D;
  const float* vb = v + static_cast<size_t>(b) * Sk * k_stride + static_cast<size_t>(hk) * D;

  load_tile_async(Qs, ld, qb, q_stride, q0, kBQ, Sq, D, kF32Threads);
  if (sp.t_begin < sp.t_end) {
    load_tile_async(Ks, ld, kb, k_stride, sp.t_begin * BK, BK, Sk, D, kF32Threads);
    load_tile_async(Vs, ld, vb, k_stride, sp.t_begin * BK, BK, Sk, D, kF32Threads);
  }
  cp_async_commit();

  float4 o[4][NI];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int n = 0; n < NI; ++n) o[i][n] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float m_run[4], l_part[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_part[i] = 0.0f;
  }

  for (int t = sp.t_begin; t < sp.t_end; ++t) {
    const int stage = (t - sp.t_begin) & 1;
    if (t + 1 < sp.t_end) {
      const int nxt = stage ^ 1;
      load_tile_async(Ks + nxt * BK * ld, ld, kb, k_stride, (t + 1) * BK, BK, Sk, D, kF32Threads);
      load_tile_async(Vs + nxt * BK * ld, ld, vb, k_stride, (t + 1) * BK, BK, Sk, D, kF32Threads);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Kt = Ks + stage * BK * ld;
    const float* Vt = Vs + stage * BK * ld;
    const int k0 = t * BK;

    // S = Q K^T: 4 rows x JK keys a thread, d in order
    float s[4][JK];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < JK; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[JK];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ry + 16 * i) * ld + d);
      }
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(Kt + (kx + kKX * j) * ld + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < JK; ++j) {
          float acc = s[i][j];
          acc = fmaf(qv[i].x, kv[j].x, acc);
          acc = fmaf(qv[i].y, kv[j].y, acc);
          acc = fmaf(qv[i].z, kv[j].z, acc);
          acc = fmaf(qv[i].w, kv[j].w, acc);
          s[i][j] = acc;
        }
      }
    }

    // online softmax: a row's 16 key-owners are one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ry + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        const float x = key_ok(k0 + kx + kKX * j, qp, Sk, causal, window) ? s[i][j] * scale
                                                                          : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = kKX / 2; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m_run[i], mx);
      const float m_safe = m_new == kNegInf ? 0.0f : m_new;
      const float alpha = m_run[i] == kNegInf ? 0.0f : expf(m_run[i] - m_safe);
      m_run[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        const float p = expf(s[i][j] - m_safe);  // 0 where masked
        s[i][j] = p;
        sum += p;
      }
      l_part[i] = l_part[i] * alpha + sum;
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        o[i][n].x *= alpha;
        o[i][n].y *= alpha;
        o[i][n].z *= alpha;
        o[i][n].w *= alpha;
      }
    }
    // P key-major, this thread's 4 rows side by side
#pragma unroll
    for (int j = 0; j < JK; ++j) {
      *reinterpret_cast<float4*>(Ps + (kx + kKX * j) * LDP + 4 * ry) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncwarp();  // the half-warp that owns these rows wrote all their keys

    // O += P V: 4 rows x NI float4 columns a thread, keys in order
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(Ps + c * LDP + 4 * ry);
      const float* vr = Vt + c * ld;
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        const int col = kx + kKX * n;
        if (col < nq4) {
          const float4 w = *reinterpret_cast<const float4*>(vr + 4 * col);
          fma4(o[0][n], p.x, w);
          fma4(o[1][n], p.y, w);
          fma4(o[2][n], p.z, w);
          fma4(o[3][n], p.w, w);
        }
      }
    }
    __syncthreads();  // the stage and P are free for the next tile
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_part[i];
#pragma unroll
    for (int off = kKX / 2; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    l = fmaxf(l, 1e-30f);
    const int qp = q0 + ry + 16 * i;
    if (qp >= Sq) continue;
    float* orow = out + static_cast<size_t>(b) * Sq * q_stride +
                  static_cast<size_t>(qp) * q_stride + static_cast<size_t>(h) * D;
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int col = kx + kKX * n;
      if (col < nq4) {
        *reinterpret_cast<float4*>(orow + 4 * col) =
            make_float4(o[i][n].x / l, o[i][n].y / l, o[i][n].z / l, o[i][n].w / l);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Bands and launch
// ---------------------------------------------------------------------------

// One kernel instance per head-dim band: the kernel, its threads, query
// rows a block, keys a tile and the shared memory a launch at head dim D
// asks for.
struct Band {
  const void* kernel;
  int threads, bq, bk;
  size_t smem;
};

template <int NC, int BK, int MT>
Band bf16_band(int D) {
  return {reinterpret_cast<const void*>(&flash_attention_bf16_kernel<NC, BK, MT>),
          kBf16Threads, 64 * MT, BK, bf16_smem_bytes<BK, MT>(D)};
}

template <int NI, int BK>
Band f32_band(int D) {
  return {reinterpret_cast<const void*>(&flash_attention_f32_kernel<NI, BK>), kF32Threads,
          kBQ, BK, f32_smem_bytes<BK>(D)};
}

// The largest head dim of each band, by dtype (0 float32, 1 bfloat16).
constexpr int kBands = 3;
constexpr int kBandTop[2][kBands] = {{64, 128, kMaxDF32}, {128, 256, kMaxDBf16}};

Band band_for(int D, int dtype) {
  if (D <= 0 || D % 16 != 0 || dtype < 0 || dtype > 1) return {nullptr, 0, 0, 0, 0};
  const int* top = kBandTop[dtype];
  if (dtype == 1 && D <= top[2]) {
    if (D <= top[0]) return bf16_band<8, 64, 2>(D);
    if (D <= top[1]) return bf16_band<16, 32, 1>(D);
    return bf16_band<20, 32, 1>(D);
  }
  if (dtype == 0 && D <= top[2]) {
    if (D <= top[0]) return f32_band<1, 64>(D);
    if (D <= top[1]) return f32_band<2, 32>(D);
    return f32_band<4, 32>(D);
  }
  return {nullptr, 0, 0, 0, 0};
}

}  // namespace

extern "C" {

// q (B, Sq, Hq, D), k / v (B, Sk, Hkv, D), out (B, Sq, Hq, D), contiguous,
// 16-byte aligned, D a multiple of 16 (up to 320 in bfloat16, 208 in
// float32), Hq a multiple of Hkv; dtype 0 float32, 1 bfloat16.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int B,
                           int Sq, int Sk, int Hq, int Hkv, int D, float scale, int causal,
                           int window, int dtype, void* stream) {
  const Band bd = band_for(D, dtype);
  if (bd.kernel == nullptr || Hkv <= 0 || Hq % Hkv != 0 || Sq < 0 || Sk < 0 ||
      bd.smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_q = (Sq + bd.bq - 1) / bd.bq;
  if (B == 0 || Hq == 0 || n_q == 0) return 0;
  if (static_cast<long long>(B) * Hq > INT_MAX || n_q > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);  // beyond the grid's x / y limits
  }
  cudaError_t e = cudaFuncSetAttribute(bd.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bd.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * Hq, n_q);
  // the kernels of both dtypes take the same arguments, pointers aside
  void* args[] = {const_cast<void**>(&q), const_cast<void**>(&k), const_cast<void**>(&v),
                  &out, &Sq, &Sk, &Hq, &Hkv, &D, &scale, &causal, &window};
  e = cudaLaunchKernel(bd.kernel, grid, dim3(bd.threads), args, bd.smem,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// dtype's number of bands, then the largest head dim of each, smallest
// first, into out (cap ints).
int flash_attention_general_bands(int dtype, int cap, int* out) {
  if (dtype < 0 || dtype > 1 || cap < kBands + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = kBands;
  for (int i = 0; i < kBands; ++i) out[1 + i] = kBandTop[dtype][i];
  return 0;
}

// What the band kernel that takes (dtype, D) is, as cudaFuncGetAttributes
// reads it from the loaded binary: registers a thread, local memory a
// thread (spills and stack), static shared memory a block, then the
// dynamic shared memory a launch at D asks for, the band's keys a tile, its
// threads and query rows a block.
int flash_attention_general_attributes(int dtype, int D, int* out) {
  const Band bd = band_for(D, dtype);
  if (bd.kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, bd.kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = static_cast<int>(bd.smem);
  out[4] = bd.bk;
  out[5] = bd.threads;
  out[6] = bd.bq;
  return 0;
}

}  // extern "C"
