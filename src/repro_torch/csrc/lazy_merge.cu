// LazySync row merge for Hopper (sm_90a).
//
// lazy_merge (ports lazy_merge_pallas, src/repro/kernels/lazy_merge/
//   lazy_merge.py:30, kernel _merge_kernel :22):
//     out[r, :] = base[r] + sum_{g=0..G-1} (rows[g, r] - base[r])  if valid[r]
//     out[r, :] = base[r]                                           otherwise
//   in float32, from float32 or bfloat16 inputs.  Bound by bytes: every
//   input element is read once and every output element written once, a
//   few float adds per element.  The TPU kernel tiles (128 rows x 128
//   lanes) into VMEM and pads R and D up to the tile; here there is no
//   tile to stage: each thread owns one 16-byte slice of one row along D
//   (4 float32 or 8 bfloat16 values), keeps the running sum in registers
//   across the small group loop, and so reads each input byte exactly
//   once with 16-byte loads where the row is aligned.  Ragged R and D are
//   masked in the kernel (the last slice of a row is partial); nothing is
//   padded.  A row that is not valid reads only its base slice.  The sum
//   runs in the reference's order, acc = sum_g (rows_g - base) from g = 0
//   up, then base + acc, with no fused multiply-add to contract, so the
//   result equals the plain PyTorch version bit for bit.
//
// Every launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Load E = 16 / sizeof(T) consecutive values starting at p (p + E <= row
// end, 16-byte aligned when kVec) into f.
template <typename T, bool kVec>
__device__ __forceinline__ void load_slice(const T* __restrict__ p, float* f,
                                           int count) {
  constexpr int E = 16 / sizeof(T);
  if (kVec && count == E) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = to_float(v[e]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = e < count ? to_float(p[e]) : 0.0f;
  }
}

// rows (G, R, D), base (R, D), valid (R,) -> out (R, D) float32.
template <typename T, bool kVec>
__global__ void lazy_merge_kernel(const T* __restrict__ rows,
                                  const T* __restrict__ base,
                                  const uint8_t* __restrict__ valid,
                                  float* __restrict__ out, int G, int R, int D) {
  constexpr int E = 16 / sizeof(T);
  const int slices = (D + E - 1) / E;
  const long long total = static_cast<long long>(R) * slices;
  const size_t plane = static_cast<size_t>(R) * D;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(idx / slices);
    const int d0 = static_cast<int>(idx % slices) * E;
    const int count = min(E, D - d0);
    const size_t off = static_cast<size_t>(r) * D + d0;
    float b[E], acc[E];
    load_slice<T, kVec>(base + off, b, count);
    if (valid[r]) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.0f;
      for (int g = 0; g < G; ++g) {
        float x[E];
        load_slice<T, kVec>(rows + g * plane + off, x, count);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = __fadd_rn(acc[e], __fsub_rn(x[e], b[e]));
      }
#pragma unroll
      for (int e = 0; e < E; ++e) b[e] = __fadd_rn(b[e], acc[e]);
    }
    float* o = out + off;
    if (count == E && (reinterpret_cast<uintptr_t>(o) & 15u) == 0) {
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        *reinterpret_cast<float4*>(o + e) = make_float4(b[e], b[e + 1], b[e + 2], b[e + 3]);
      }
    } else {
      for (int e = 0; e < count; ++e) o[e] = b[e];
    }
  }
}

template <typename T>
int launch_typed(const void* rows, const void* base, const void* valid,
                 void* out, int G, int R, int D, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const long long total = static_cast<long long>(R) * ((D + E - 1) / E);
  if (total == 0) return 0;
  // Enough blocks to fill 132 SMs several times over; the grid-stride loop
  // covers the rest.
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(std::min<long long>(want, 132LL * 32));
  // 16-byte loads need every row start aligned: D a multiple of E and the
  // three base pointers 16-byte aligned.
  const bool vec = D % E == 0 &&
                   ((reinterpret_cast<uintptr_t>(rows) |
                     reinterpret_cast<uintptr_t>(base)) & 15u) == 0;
  if (vec) {
    lazy_merge_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(rows), static_cast<const T*>(base),
        static_cast<const uint8_t*>(valid), static_cast<float*>(out), G, R, D);
  } else {
    lazy_merge_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(rows), static_cast<const T*>(base),
        static_cast<const uint8_t*>(valid), static_cast<float*>(out), G, R, D);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (rows and base share it).
int lazy_merge_launch(const void* rows, const void* base, const void* valid,
                      void* out, int G, int R, int D, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(rows, base, valid, out, G, R, D, s);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(rows, base, valid, out, G, R, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
