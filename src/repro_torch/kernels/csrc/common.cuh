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

}  // namespace rt
