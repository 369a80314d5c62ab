// Shared device helpers of the port's hand-written CUDA kernels.
//
// Registers are int8, row-major in an [n_rows, num_regs] matrix with
// num_regs a multiple of 4 and 4-byte aligned rows (the wrappers check it).
// A thread moves them four at a time, packed in one 32-bit word: byte b of
// word w is register 4w + b. VISITED (-1) is the byte 0xFF, the bottom of
// the signed max.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kGold = 0x9E3779B9u;
constexpr int kWarp = 32;

// murmur3 fmix32, as core/sampling.py mix32
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 13;
  x *= kM2;
  x ^= x >> 16;
  return x;
}

// The edge-activation predicate. PRED 0: ((x ^ h) - lo) < thr (wc, ic, dic);
// PRED 1: (mix32(x ^ h) - lo) < thr (lt). uint32 wraparound is intended.
template <int PRED>
__device__ __forceinline__ bool live(uint32_t h, uint32_t lo, uint32_t thr,
                                     uint32_t x) {
  uint32_t y = x ^ h;
  if (PRED == 1) y = mix32(y);
  return (y - lo) < thr;
}

__device__ __forceinline__ uint32_t load_word(const int8_t* row, int w) {
  return __ldg(reinterpret_cast<const uint32_t*>(row) + w);
}

__device__ __forceinline__ void store_word(int8_t* row, int w, uint32_t v) {
  reinterpret_cast<uint32_t*>(row)[w] = v;
}

// 0xFF in every byte that is VISITED, 0 elsewhere
__device__ __forceinline__ uint32_t visited_bytes(uint32_t v) {
  return __vcmpeq4(v, 0xFFFFFFFFu);
}

// the layout the kernels take: whole 32-bit words per row, aligned bases
inline bool rows_aligned(int num_regs, const void* a, const void* b) {
  return num_regs % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 4 == 0;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ------------------------------------------------ work-item row walk ----
//
// The work-item sweeps (items.cuh) give one warp each work item
// (kernels/edges.py, WorkList): at most item_edges edges of one write row.
// The warp takes the row's registers in passes of kChunkWords words, a lane
// holding kLaneWords of them. In a pass it walks the item's edges once:
//  * lanes load 32 edges' (nbr, h, lo, thr) at a time, one coalesced load
//    per array, and broadcast each edge with __shfl_sync;
//  * the gathered rows m[nbr[e], pass] come into a ring of kStages slots of
//    shared memory per warp by cp.async, kStages edges ahead, so the
//    predicate work on one edge overlaps the gather of the next one.
// Each lane copies, and later reads, only its own units of a slot, so the
// cp.async wait alone orders its copies before its reads (no warp barrier).
// A unit is VEC bytes: 16 (one 16-byte cp.async, one 16-byte shared load)
// where the register count is a multiple of 16 and the bases 16-byte
// aligned (and x's base), else 4.

constexpr int kLaneWords = 8;
constexpr int kChunkWords = kWarp * kLaneWords;  // 1024 registers a pass
constexpr int kChunkBytes = kChunkWords * 4;
constexpr int kStages = 2;  // deeper rings measured slower on the H100
// warps (items) per block: 4 by default; kernels/build.py compiles the single
// path's sweeps once per block shape with -DREPRO_ITEM_WARPS=<w>
#ifndef REPRO_ITEM_WARPS
#define REPRO_ITEM_WARPS 4
#endif
constexpr int kItemWarps = REPRO_ITEM_WARPS;
static_assert(kItemWarps >= 1 && kItemWarps <= 32, "REPRO_ITEM_WARPS must be 1..32");
constexpr int kRingBytes = kItemWarps * kStages * kChunkBytes;
// dynamic shared memory a block gets without an opt-in attribute
constexpr int kDefaultSharedBytes = 48 * 1024;

// word of the row that lane's t-th word of the pass starting at base is:
// units of VEC/4 words, unit k of lane at (k * 32 + lane)
template <int VEC>
__device__ __forceinline__ int lane_word(int base, int lane, int t) {
  constexpr int wpu = VEC / 4;
  return base + ((t / wpu) * kWarp + lane) * wpu + t % wpu;
}

template <int VEC>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the x values of lane's registers in the pass at base
template <int VEC>
__device__ __forceinline__ void load_lane_x(const uint32_t* __restrict__ x, int base,
                                            int lane, int nwords,
                                            uint32_t (&xs)[kLaneWords][4]) {
#pragma unroll
  for (int t = 0; t < kLaneWords; ++t) {
    const int i = lane_word<VEC>(base, lane, t);
    if (i < nwords) {
      if constexpr (VEC == 16) {  // x is 16-byte aligned on this path
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(x) + i);
        xs[t][0] = v.x, xs[t][1] = v.y, xs[t][2] = v.z, xs[t][3] = v.w;
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b) xs[t][b] = __ldg(x + 4 * i + b);
      }
    } else {
      xs[t][0] = xs[t][1] = xs[t][2] = xs[t][3] = 0u;
    }
  }
}

// 0xFF in each byte b of the word whose register (x value xw[b]) the edge
// (h, lo, thr) samples
template <int PRED>
__device__ __forceinline__ uint32_t live_bytes(uint32_t h, uint32_t lo, uint32_t thr,
                                               const uint32_t (&xw)[4]) {
  uint32_t bytes = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (live<PRED>(h, lo, thr, xw[b])) bytes |= 0xFFu << (8 * b);
  return bytes;
}

// Walk the edges e0 .. e0 + ne - 1 for the pass at base: for each edge in
// order, f(h, lo, thr, words) with words the lane's words of m[nbr[e]]
// (0 for words past the row's end). The warp calls it together: ne and
// base must be the same on every lane.
template <int VEC, class F>
__device__ __forceinline__ void walk_edges(const int8_t* __restrict__ m, int num_regs,
                                           int base, const int32_t* __restrict__ nbr,
                                           const uint32_t* __restrict__ h,
                                           const uint32_t* __restrict__ lo,
                                           const uint32_t* __restrict__ thr, int e0,
                                           int ne, uint8_t* ring, int lane, F&& f) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  constexpr int wpu = VEC / 4;
  const int nwords = num_regs / 4;
  // the batch of 32 edges the copies read next (nbr), and the predicate
  // operands of that batch (pending) and of the one being walked (cur)
  int bnbr = 0;
  uint32_t ph = 0, plo = 0, pthr = 0, ch = 0, clo = 0, cthr = 0;
  auto issue = [&](int j) {
    if (j < ne) {
      if (j % kWarp == 0 && j + lane < ne) {
        const int e = e0 + j + lane;
        bnbr = __ldg(nbr + e);
        ph = __ldg(h + e), plo = __ldg(lo + e), pthr = __ldg(thr + e);
      }
      const int v = __shfl_sync(kAll, bnbr, j % kWarp);
      const int8_t* src = m + static_cast<long long>(v) * num_regs;
      uint8_t* dst = ring + (j % kStages) * kChunkBytes;
#pragma unroll
      for (int k = 0; k < kLaneWords / wpu; ++k) {
        const int i = lane_word<VEC>(base, lane, k * wpu);
        if (i < nwords) cp_async<VEC>(dst + (i - base) * 4, src + i * 4);
      }
    }
    cp_async_commit();  // one group per edge, empty past the end
  };
#pragma unroll
  for (int s = 0; s < kStages; ++s) issue(s);
  for (int i = 0; i < ne; ++i) {
    if (i % kWarp == 0) ch = ph, clo = plo, cthr = pthr;
    const int src_lane = i % kWarp;
    const uint32_t he = __shfl_sync(kAll, ch, src_lane);
    const uint32_t le = __shfl_sync(kAll, clo, src_lane);
    const uint32_t te = __shfl_sync(kAll, cthr, src_lane);
    cp_async_wait<kStages - 1>();  // edge i's group has landed
    const uint8_t* slot = ring + (i % kStages) * kChunkBytes;
    uint32_t words[kLaneWords];
#pragma unroll
    for (int k = 0; k < kLaneWords / wpu; ++k) {
      const int i0 = lane_word<VEC>(base, lane, k * wpu);
      if (i0 < nwords) {
        if constexpr (VEC == 16) {
          const uint4 v = *reinterpret_cast<const uint4*>(slot + (i0 - base) * 4);
          words[k * 4] = v.x, words[k * 4 + 1] = v.y;
          words[k * 4 + 2] = v.z, words[k * 4 + 3] = v.w;
        } else {
          words[k] = *reinterpret_cast<const uint32_t*>(slot + (i0 - base) * 4);
        }
      } else {
#pragma unroll
        for (int q = 0; q < wpu; ++q) words[k * wpu + q] = 0u;
      }
    }
    f(he, le, te, words);
    issue(i + kStages);  // into the slot just read
  }
  cp_async_wait<0>();
}

}  // namespace rt
