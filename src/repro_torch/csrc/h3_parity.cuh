// H3 in parity form, shared by bloom.cu (bloom_query, bloom_insert) and
// bloom_onehot.cu (bloom_query_onehot, bloom_insert_onehot).
//
// H3 is linear over GF(2): segment m hashes a 32-bit address a to
// XOR_j a_j * q[m][j], a value below seg_bits = 2^log_seg.  So bit k of that
// value is the parity of a & C[m][k], where column mask C[m][k] has bit j set
// iff bit k of q[m][j] is set.  The paper's geometry needs M * log_seg =
// 4 * 9 = 36 masks (144 bytes); they give, bit for bit, the positions of the
// byte-sliced tables (hash_with_tables on the PyTorch side) and of the
// per-bit xor-fold.
//
// The masks reach a kernel by value: the launcher copies them from a host
// pointer into Columns and passes it as a __grid_constant__ kernel
// parameter, so they sit in the constant bank (no staging, no local copy
// under dynamic indexing), and every lane of a warp reads the same mask at
// the same time, which the constant cache broadcasts.  Each kernel that
// hashes is built twice: with the paper's geometry fixed (kPaperM,
// kPaperLog) and for any other; its launcher picks one by the spec.
// all_set tests an address's M positions (the queries); positions hands
// each of them to a callback (the inserts).
//
// Columns holds at most kMaxColumns masks: M * log_seg <= 512 covers every
// spec up to 32 segments of 2^16 bits, or 64 of 2^8, in one launch.  A
// spec with more masks is hashed in passes, each a launch over a run of
// whole segments: Columns.m0 is the pass's first global segment, so its
// positions are (m0 + m) << log_seg | h; the queries AND their passes'
// results and the inserts OR theirs (the PyTorch wrappers drive the
// passes).  log_seg may be up to 31 (positions are 32-bit).

#pragma once

#include <cstdint>
#include <cstring>

namespace h3p {

constexpr int kMaxLog = 31;        // log2(seg_bits) <= 31
constexpr int kMaxColumns = 512;   // masks a launch: M * log_seg <= 512

struct Columns {
  uint32_t c[kMaxColumns];  // c[m * log_seg + k]
  uint32_t m0;              // the first global segment of this pass
};

// Columns from the host's (M, log_seg) uint32 masks of the segments m0 ..
// m0 + M - 1; callers keep M * log_seg <= kMaxColumns.
inline Columns load_columns(const void* host, int M, int log_seg, int m0) {
  Columns cols{};
  std::memcpy(cols.c, host, static_cast<size_t>(M) * log_seg * sizeof(uint32_t));
  cols.m0 = static_cast<uint32_t>(m0);
  return cols;
}

// Global position of the pass's segment m's hash of address a:
// ((m0 + m) << log_seg) | h.  MC, LOGC > 0 fix the geometry at compile
// time (one pass, m0 = 0): inside a loop over m that the caller unrolls,
// every mask index is then a constant, so each AND takes its mask straight
// from the constant bank as an operand instead of issuing a load for it;
// MC = LOGC = 0 takes log_seg and m0 at run time.
template <int MC, int LOGC>
__device__ __forceinline__ uint32_t position(const Columns& cols, uint32_t a, int m,
                                             int log_seg) {
  uint32_t h = 0u;
  if constexpr (MC > 0) {
#pragma unroll
    for (int k = 0; k < LOGC; ++k) {
      h |= (static_cast<uint32_t>(__popc(a & cols.c[m * LOGC + k])) & 1u) << k;
    }
    return (static_cast<uint32_t>(m) << LOGC) | h;
  } else {
    const uint32_t* col = cols.c + m * log_seg;
#pragma unroll
    for (int k = 0; k < kMaxLog; ++k) {
      if (k < log_seg) h |= (static_cast<uint32_t>(__popc(a & col[k])) & 1u) << k;
    }
    return ((cols.m0 + static_cast<uint32_t>(m)) << log_seg) | h;
  }
}

// True iff all M positions of address a are set in the packed bit words
// `words`, stopping at the first clear one.
template <int MC, int LOGC>
__device__ __forceinline__ bool all_set(const Columns& cols,
                                        const uint32_t* __restrict__ words,
                                        uint32_t a, int M, int log_seg) {
  if constexpr (MC > 0) {
#pragma unroll
    for (int m = 0; m < MC; ++m) {
      const uint32_t p = position<MC, LOGC>(cols, a, m, log_seg);
      if (!((words[p >> 5] >> (p & 31u)) & 1u)) return false;
    }
  } else {
    for (int m = 0; m < M; ++m) {
      const uint32_t p = position<0, 0>(cols, a, m, log_seg);
      if (!((words[p >> 5] >> (p & 31u)) & 1u)) return false;
    }
  }
  return true;
}

// Calls f(p) for each of the M positions p of address a, segment by
// segment (every one: an insert sets them all).
template <int MC, int LOGC, typename F>
__device__ __forceinline__ void positions(const Columns& cols, uint32_t a, int M,
                                          int log_seg, F&& f) {
  if constexpr (MC > 0) {
#pragma unroll
    for (int m = 0; m < MC; ++m) f(position<MC, LOGC>(cols, a, m, log_seg));
  } else {
    for (int m = 0; m < M; ++m) f(position<0, 0>(cols, a, m, log_seg));
  }
}

// The paper's geometry (2,048-bit registers, M = 4 segments of 512 bits),
// which every main path uses, is compiled with its sizes fixed; a pass of a
// larger spec that happens to hold 4 segments of 512 bits is not it.
constexpr int kPaperM = 4;
constexpr int kPaperLog = 9;

inline bool paper_geometry(int M, int log_seg, int m0 = 0) {
  return M == kPaperM && log_seg == kPaperLog && m0 == 0;
}

}  // namespace h3p
