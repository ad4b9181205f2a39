// Flash attention for Hopper (sm_90a): bf16 GQA, causal / sliding-window,
// with register accumulators, a TMA-fed K/V ring and wgmma.
//
// flash_attention_sm90 (ports flash_attention_pallas, src/repro/kernels/
//   flash_attention/flash_attention.py:82, pallas_call :118, body
//   _fa_kernel :35) computes what flash_attention.cu computes, for bfloat16
//   and the head dims D in {64, 96, 128, 192, 256} (the model zoo's): q (B,
//   Sq, Hq, D), k and v (B, Sk, Hkv, D), out (B, Sq, Hq, D), all bfloat16,
//     s[i, j] = (q_i . k_j) * D**-0.5, masked where j >= Sk, or (causal)
//       j > i, or (causal, window > 0) j <= i - window;
//     out_i = sum_j softmax_j(s[i, :]) v_j          (0 for a row with no key)
//   with the TPU kernel's online softmax (running max m, sum l, float32
//   accumulator; alpha = 0 while m is still at the mask value, m_safe = 0
//   while the row has seen no key) and out = acc / max(l, 1e-30).  Query
//   head h reads kv head h / (Hq / Hkv).  The wrapper routes bfloat16 calls
//   with these head dims here and every other call to flash_attention.cu.
//
// What bounds it: at the prefill path's shape (4 x 4,096 tokens, 32 query
// heads, 8 kv heads, D = 128, causal) the two products do ~5.5e11 useful
// flops on ~335 MB of inputs and output, so the tensor cores set the floor
// (0.56 ms at 989 TFLOP/s in bf16).  flash_attention.cu kept its float32
// accumulator in shared memory (101.5 KB a block, two blocks an SM),
// round-tripped S and P through shared memory, softmaxed one row at a time,
// reloaded Q for every WMMA (mma.sync) product and loaded K/V synchronously.
// This design:
// - one block owns one (batch, query head, 128-row query tile) and has two
//   warpgroups of 64 query rows each; S (64 x BK keys: BK = 128 for D <=
//   128, 64 above, so that the ring fits 227 KB) and the float32 O
//   accumulator (64 x D) live in registers for the whole KV loop,
//   in wgmma's accumulator layout: a thread holds two rows, so a row's max
//   and sum take two shuffles among the four threads that share it, and
//   the softmax is one FMA (scale * log2 e folded in) and one exp2f an
//   element, masked only in the tiles that straddle the diagonal, the
//   window edge or Sk;
// - P goes to the PV product from registers as two bf16 parts, hi =
//   bf16(P) and lo = bf16(P - hi), each the A operand of a wgmma into the
//   same accumulator (the accumulator's fragment layout is the A fragment
//   layout of a 16-bit wgmma): hi + lo holds P to ~2^-17, so PV keeps the
//   TPU kernel's float32 P.  A single bf16 P (2^-9) strayed past the bf16
//   tolerance on a training step's activations, whose V has channels far
//   above the output row's RMS; the second product makes the tensor-core
//   work half as much again;
// - both products are wgmma: S = Q K^T is m64nBKk16 with Q and K read from
//   shared memory through descriptors (K-major, 128-byte swizzle), O += P V
//   is m64nDk16 with P from registers and V read MN-major (the transpose
//   bit) from the same swizzled tiles; D = 96 runs as 128 with the last 32
//   columns zero (TMA fills the columns past D of the second 64-column box
//   with zeros, and the epilogue stores only D), so every row is a whole
//   number of 128-byte swizzle rows;
// - Q (128 x D) is loaded once by TMA; K and V tiles of BK keys go through
//   a 2-stage ring: one thread issues tile t + 1's TMA loads (expect_tx on
//   the stage's "full" mbarrier) before its warpgroup computes tile t, so
//   each copy overlaps a tile of math; every thread arrives on the stage's
//   "empty" mbarrier when done with it, and the loading thread waits on
//   that before refilling, so the two warpgroups are not held in lockstep
//   (each may run up to a tile ahead of the other); rows past Sq or Sk
//   arrive zero-filled by TMA and are masked or not stored, so nothing is
//   padded;
// - the loop visits only the KV tiles that touch the causal / window band,
//   and the heaviest query tiles are scheduled first;
// - the epilogue divides by l, rounds to bf16, stages the 64 x D tile in
//   the warpgroup's own (swizzled) Q rows and stores 16 bytes a thread.
// Shared memory: Q 32 KB + 2 stages x (K + V) 64 KB = 160 KB at D = 128
// (and 96), 145 KB at 192, 193 KB at 256: one block an SM, 8 warps.  Not
// done (later perf work): a producer warp or warpgroup with setmaxnreg,
// ping-pong between the two warpgroups, and the softmax of one tile
// overlapping the PV product of the last (tried, and slower in the forms
// tried: PERF.md says which and why), and a persistent grid.
//
// The tensor maps are built on the host with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint (nothing links libcuda), and
// passed as __grid_constant__ parameters.  Every launch runs on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 128;          // query rows a block
constexpr int kWGRows = 64;       // query rows a consumer warpgroup
constexpr int kThreads = 256;     // two consumer warpgroups
constexpr int kStages = 2;        // K/V ring depth
constexpr int kSwz = 64;          // bf16 columns in one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90
// An mbarrier wait that has not completed after this many cycles (~8 s)
// traps, so a copy that never lands fails the launch instead of hanging.
constexpr long long kWaitTrapCycles = 1ll << 34;

// Shared-memory layout for head dim D, from a 1024-byte aligned base: Q
// (128 rows), then K stages 0, 1, then V stages 0, 1, then the mbarriers:
// "full" for stages 0, 1 (the tile landed), "empty" for stages 0, 1 (all
// threads are done with it), Q's.  Each tile is stored as kDP / 64 column
// blocks (D rounded up to a multiple of 64) of [rows][64] bf16, 128-byte
// swizzled, as TMA writes a box of {64 columns, rows} with
// CU_TENSOR_MAP_SWIZZLE_128B.
template <int D>
struct Smem {
  static constexpr int kDP = (D + kSwz - 1) / kSwz * kSwz;  // D padded to 64-column blocks
  static constexpr int kBK = kDP <= 128 ? 128 : 64;  // keys a KV tile: the ring fits 227 KB
  static constexpr int kBlocks = kDP / kSwz;
  static constexpr uint32_t kQBytes = kBQ * kDP * 2;
  static constexpr uint32_t kTileBytes = kBK * kDP * 2;
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBar = kV + kStages * kTileBytes;
  static constexpr size_t kBytes = 1024 + kBar + (2 * kStages + 1) * 8;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > kWaitTrapCycles) __trap();
  } while (!done);
}

// One TMA box of a 4-D map {D, H, S, B} into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wait (or reusing them before it).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units).  K-major operands use
// only the stride offset (8 rows of 128 bytes); the MN-major V operand uses
// the leading offset to step from one 64-column block to the next.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// What pack_bf16(lo, hi) == packed rounded away, itself rounded to bf16.
__device__ __forceinline__ uint32_t pack_bf16_rest(float lo, float hi, uint32_t packed) {
  const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed));
  return pack_bf16(lo - r.x, hi - r.y);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// d (64 x 64) (+)= A B^T: A 64 x 16 and B 64 x 16, both K-major in
// 128-byte-swizzled shared memory (descriptors da, db); d is overwritten
// when accumulate is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128) (+)= A B^T: A 64 x 16 and B 128 x 16, both K-major in
// 128-byte-swizzled shared memory (descriptors da, db); d is overwritten
// when accumulate is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A B: A 64 x 16 bf16 from registers (a0..a3, the
// accumulator's fragment layout), B 16 x 64 MN-major in 128-byte-swizzled
// shared memory (descriptor db, transposed); always accumulates.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d (64 x 128) += A B: A 64 x 16 bf16 from registers (a0..a3, the
// accumulator's fragment layout), B 16 x 128 MN-major in 128-byte-swizzled
// shared memory (descriptor db, transposed); always accumulates.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d (64 x 192) += A B: A 64 x 16 bf16 from registers (a0..a3, the
// accumulator's fragment layout), B 16 x 192 MN-major in 128-byte-swizzled
// shared memory (descriptor db, transposed); always accumulates.
__device__ __forceinline__ void wgmma_rs(float (&d)[96], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d (64 x 256) += A B: A 64 x 16 bf16 from registers (a0..a3, the
// accumulator's fragment layout), B 16 x 256 MN-major in 128-byte-swizzled
// shared memory (descriptor db, transposed); always accumulates.
__device__ __forceinline__ void wgmma_rs(float (&d)[128], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// Whether key position kp is unmasked for query position qp.
__device__ __forceinline__ bool key_ok(int kp, int qp, int Sk, int causal, int window) {
  bool ok = kp < Sk;
  if (causal) {
    ok = ok && kp <= qp;
    if (window > 0) ok = ok && kp > qp - window;
  }
  return ok;
}

// One block: (batch b, query head h) = blockIdx.x, 128-row query tile from
// blockIdx.y (heaviest first).  Two warpgroups of 128 threads; warpgroup wg
// owns rows [q0 + 64 wg, q0 + 64 wg + 64), thread (warp w, lane) the rows
// 16 w + lane / 4 and that + 8, and in S and O the columns 8 j + 2 (lane % 4)
// + {0, 1} of each 8-column group j (wgmma's accumulator layout).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ out, int Sq, int Sk, int Hq, int Hkv,
                            float scale_log2, int causal, int window) {
  using L = Smem<D>;
  constexpr int kNB = L::kBlocks;
  constexpr int kBK = L::kBK;
  constexpr int kDP = L::kDP;  // the padded columns hold zeros (TMA's fill)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms need 1024-byte alignment
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_kv = base + L::kBar;  // + 8 * stage
  const uint32_t bar_empty = bar_kv + 8 * kStages;
  const uint32_t bar_q = bar_empty + 8 * kStages;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int qw0 = q0 + wg * kWGRows;
  const int r_in = wg * kWGRows + warp * 16 + (lane >> 2);  // row a within the block's tile
  const int row_a = q0 + r_in;
  const int row_b = row_a + 8;

  // KV tiles that hold at least one unmasked key for some row of the block.
  int k_begin = 0, k_end = Sk;
  if (causal) {
    k_end = min(Sk, q0 + kBQ);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  const int t_begin = k_begin / kBK;
  const int n_tiles = k_end > k_begin ? (k_end + kBK - 1) / kBK - t_begin : 0;

  auto load_kv = [&](int stage, int tile) {
    const uint32_t bar = bar_kv + 8 * stage;
    mbar_expect_tx(bar, 2 * L::kTileBytes);
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      const uint32_t off = stage * L::kTileBytes + nb * kBK * kRowBytes;
      tma_load(base + L::kK + off, &tk, bar, nb * kSwz, hk, tile * kBK, b);
      tma_load(base + L::kV + off, &tv, bar, nb * kSwz, hk, tile * kBK, b);
    }
  };

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_kv + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kThreads);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      tma_load(base + nb * kBQ * kRowBytes, &tq, bar_q, nb * kSwz, h, q0, b);
    }
    for (int j = 0; j < kStages - 1 && j < n_tiles; ++j) load_kv(j, t_begin + j);
  }

  float o[kDP / 2];
#pragma unroll
  for (int i = 0; i < kDP / 2; ++i) o[i] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max of the raw scores
  float l_a = 0.0f, l_b = 0.0f;            // this thread's part of the row sums
  const uint32_t q_wg = base + wg * kWGRows * kRowBytes;
  mbar_wait(bar_q, 0);
  __syncwarp();

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (t_begin + it) * kBK;
    const int stage = it % kStages;
    if (tid == 0 && it + kStages - 1 < n_tiles) {
      const int st = (it + kStages - 1) % kStages;  // held tile it - 1
      if (it >= 1) mbar_wait(bar_empty + 8 * st, ((it - 1) / kStages) & 1);
      load_kv(st, t_begin + it + kStages - 1);
    }
    mbar_wait(bar_kv + 8 * stage, (it / kStages) & 1);
    __syncwarp();

    // S = Q K^T, 16 columns of D a step (four steps a 64-column block).
    float s[kBK / 2];
    const uint32_t k_st = base + L::kK + stage * L::kTileBytes;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kDP / 16; ++ks) {
      const uint32_t col = (ks & 3) * 32;
      const uint64_t da = desc_sw128(q_wg + (ks >> 2) * kBQ * kRowBytes + col, 16, 1024);
      const uint64_t db = desc_sw128(k_st + (ks >> 2) * kBK * kRowBytes + col, 16, 1024);
      wgmma_ss(s, da, db, ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Mask only where the tile straddles Sk, the diagonal or the window edge
    // for some row of this warpgroup.
    const bool straddle =
        k0 + kBK > Sk ||
        (causal && (k0 + kBK - 1 > qw0 || (window > 0 && k0 <= qw0 + kWGRows - 1 - window)));
    if (straddle) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + 2 * (lane & 3) + e;
          if (!key_ok(kp, row_a, Sk, causal, window)) s[4 * j + e] = -INFINITY;
          if (!key_ok(kp, row_b, Sk, causal, window)) s[4 * j + 2 + e] = -INFINITY;
        }
      }
    }

    // Online softmax in registers (the reference's m_safe / alpha rules; a
    // masked score is -inf, so its exp2f is 0).
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float ms_a = mn_a == -INFINITY ? 0.0f : mn_a * scale_log2;
    const float ms_b = mn_b == -INFINITY ? 0.0f : mn_b * scale_log2;
    const float al_a = m_a == -INFINITY ? 0.0f : exp2f(m_a * scale_log2 - ms_a);
    const float al_b = m_b == -INFINITY ? 0.0f : exp2f(m_b * scale_log2 - ms_b);
    m_a = mn_a;
    m_b = mn_b;
    uint32_t p[kBK / 4];   // bf16(P) in pairs: the A fragments of the PV product
    uint32_t pr[kBK / 4];  // bf16(P - bf16(P)) in pairs: those of the second one
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float p0 = exp2f(fmaf(s[4 * j], scale_log2, -ms_a));
      const float p1 = exp2f(fmaf(s[4 * j + 1], scale_log2, -ms_a));
      const float p2 = exp2f(fmaf(s[4 * j + 2], scale_log2, -ms_b));
      const float p3 = exp2f(fmaf(s[4 * j + 3], scale_log2, -ms_b));
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      p[2 * j] = pack_bf16(p0, p1);
      p[2 * j + 1] = pack_bf16(p2, p3);
      pr[2 * j] = pack_bf16_rest(p0, p1, p[2 * j]);
      pr[2 * j + 1] = pack_bf16_rest(p2, p3, p[2 * j + 1]);
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int j = 0; j < kDP / 8; ++j) {
      o[4 * j] *= al_a;
      o[4 * j + 1] *= al_a;
      o[4 * j + 2] *= al_b;
      o[4 * j + 3] *= al_b;
    }

    // O += P V as hi V + lo V, 16 keys a step: P's fragments for keys
    // [16 kk, 16 kk + 16) are accumulator groups 2 kk and 2 kk + 1.
    const uint32_t v_st = base + L::kV + stage * L::kTileBytes;
    fence_regs(o);
    fence_regs(p);
    fence_regs(pr);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = desc_sw128(v_st + kk * 16 * kRowBytes, kBK * kRowBytes, 1024);
      wgmma_rs(o, pr[4 * kk], pr[4 * kk + 1], pr[4 * kk + 2], pr[4 * kk + 3], db);
      wgmma_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(p);
    fence_regs(pr);
    mbar_arrive(bar_empty + 8 * stage);  // this thread is done with the stage
  }

  // Epilogue: out = O / max(l, 1e-30) in bf16, staged in this warpgroup's
  // own Q rows (same swizzle), then 16-byte stores of the rows < Sq.
  const float den_a = fmaxf(quad_sum(l_a), 1e-30f);
  const float den_b = fmaxf(quad_sum(l_b), 1e-30f);
#pragma unroll
  for (int j = 0; j < kDP / 8; ++j) {
    const uint32_t at = (j / 8) * kBQ * kRowBytes + ((((j & 7) ^ (r_in & 7))) << 4) +
                        (lane & 3) * 4 + r_in * kRowBytes;
    *reinterpret_cast<uint32_t*>(smem + at) = pack_bf16(o[4 * j] / den_a, o[4 * j + 1] / den_a);
    *reinterpret_cast<uint32_t*>(smem + at + 8 * kRowBytes) =
        pack_bf16(o[4 * j + 2] / den_b, o[4 * j + 3] / den_b);
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(2 * kWGRows) : "memory");
  constexpr int kChunks = D / 8;  // 16-byte chunks a row (the padding is not stored)
  for (int c = tid & 127; c < kWGRows * kChunks; c += 128) {
    const int r = wg * kWGRows + c / kChunks;
    const int ch = c % kChunks;
    if (q0 + r < Sq) {
      const uint4 val = *reinterpret_cast<const uint4*>(
          smem + (ch / 8) * kBQ * kRowBytes + r * kRowBytes + (((ch & 7) ^ (r & 7)) << 4));
      *reinterpret_cast<uint4*>(
          out + ((static_cast<size_t>(b) * Sq + q0 + r) * Hq + h) * D + ch * 8) = val;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime (nothing links libcuda).
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The 4-D map {D, H, S, B} (innermost first) of a contiguous (B, S, H, D)
// bf16 tensor, boxes of {64 columns, 1 head, rows, 1 batch}, 128-byte
// swizzle; rows past S read as zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int D, int H, int S,
              int B, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kSwz), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
             int Hq, int Hkv, float scale, int causal, int window, cudaStream_t stream) {
  using L = Smem<D>;
  static_assert(L::kBytes <= kMaxSmem, "the tiles must fit a block's shared memory");
  const int n_q = (Sq + kBQ - 1) / kBQ;
  if (B == 0 || Hq == 0 || n_q == 0) return 0;
  if (static_cast<long long>(B) * Hq > INT_MAX || n_q > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);  // beyond the grid's x / y limits
  }
  if (Sk == 0) {  // no key at all: every row is 0
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(B) * Sq * Hq * D * sizeof(__nv_bfloat16), stream));
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap mq, mk, mv;
  if (!make_map(encode, &mq, q, D, Hq, Sq, B, kBQ) ||
      !make_map(encode, &mk, k, D, Hkv, Sk, B, L::kBK) ||
      !make_map(encode, &mv, v, D, Hkv, Sk, B, L::kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaFuncSetAttribute(flash_attention_sm90_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::kBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * Hq, n_q);
  flash_attention_sm90_kernel<D><<<grid, kThreads, L::kBytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), Sq, Sk, Hq, Hkv, scale * kLog2e, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int attributes_d(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, flash_attention_sm90_kernel<D>);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = static_cast<int>(Smem<D>::kBytes);
  return 0;
}

}  // namespace

extern "C" {

// The arguments of flash_attention_launch (flash_attention.cu): q (B, Sq,
// Hq, D), k / v (B, Sk, Hkv, D), out (B, Sq, Hq, D), contiguous, 16-byte
// aligned, Hq a multiple of Hkv; this entry takes dtype 1 (bfloat16) and D
// in {64, 96, 128, 192, 256} and refuses anything else with cudaErrorInvalidValue.
int flash_attention_sm90_launch(const void* q, const void* k, const void* v, void* out, int B,
                                int Sq, int Sk, int Hq, int Hkv, int D, float scale, int causal,
                                int window, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1 || Hkv <= 0 || Hq % Hkv != 0 || Sq < 0 || Sk < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (D) {
    case 64: return launch_d<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, window, s);
    case 96: return launch_d<96>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, window, s);
    case 128: return launch_d<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, window, s);
    case 192: return launch_d<192>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, window, s);
    case 256: return launch_d<256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// What the loaded head-dim-D kernel takes, read by cudaFuncGetAttributes:
// out[0] registers a thread, out[1] local memory a thread (spills and
// stack), out[2] static and out[3] dynamic shared memory a block.
int flash_attention_sm90_attributes(int D, int* out) {
  switch (D) {
    case 64: return attributes_d<64>(out);
    case 96: return attributes_d<96>(out);
    case 128: return attributes_d<128>(out);
    case 192: return attributes_d<192>(out);
    case 256: return attributes_d<256>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
