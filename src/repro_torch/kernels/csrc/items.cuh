// Work-item sweeps over grouped rows, shared by the single path's propagate
// and cascade sweeps (sketch_propagate.cu, cascade_step.cu), the serial
// ring's propagate and cascade merges (bucket_propagate.cu) and its fused
// prologue (fused_sweep.cu).
//
// The rows a sweep writes come cut into work items of at most item_edges
// edges (kernels/edges.py, WorkList; CHUNK by default). One warp takes one
// item, kItemWarps items a block:
//  1. it starts from its row's words in `self_in`, walks the item's edges
//     (common.cuh, walk_edges), gathering each edge's read row of `gather`
//     into a shared-memory ring by cp.async, and folds them in with OP;
//  2. an item that is its whole row writes the row of `out` and the changed
//     flag; an item of a split row writes its running value to its own slot
//     of `partial`;
//  3. a second launch (item_combine) folds each split row's partials into
//     its row of `self_in` and writes the row of `out`. Max and OR are
//     commutative, associative and idempotent, so any split of a row's edges
//     gives the same bytes; no atomics.
// Only the warp that owns a row (or, for a split row, the combine thread of
// each word) writes it, so the sweep is race-free.
//
// Pointer roles of the callers:
//   single sweeps:      self_in = gather = m_in, out = a fresh matrix;
//   fused prologue:     self_in = gather = cur,  out = next (ping-pong);
//   bucket merges:      self_in = out = acc (IN_PLACE), gather = block.
// IN_PLACE: `self_in` is written during the launch, so its words are read
// with plain coherent loads (never __ldg, ld.global.nc) and neither it nor
// `out` is __restrict__; an item without edges returns at once (its row
// keeps its bytes), and only words that change are stored. `gather` must
// not share memory with `out` (the wrappers check it).
#pragma once

#include "common.cuh"

namespace rt {

// A word of a row: __ldg where the matrix is read-only for the launch, a
// plain load where the launch writes it (IN_PLACE)
template <bool IN_PLACE>
__device__ __forceinline__ uint32_t own_word(const int8_t* row, int w) {
  if constexpr (IN_PLACE) {
    return reinterpret_cast<const uint32_t*>(row)[w];
  } else {
    return load_word(row, w);
  }
}

// words t of the pass at base that lie inside the row
template <int VEC, bool IN_PLACE>
__device__ __forceinline__ void load_lane_words(const int8_t* row, int base, int lane,
                                                int nwords, uint32_t (&w)[kLaneWords]) {
#pragma unroll
  for (int t = 0; t < kLaneWords; ++t) {
    const int i = lane_word<VEC>(base, lane, t);
    w[t] = i < nwords ? own_word<IN_PLACE>(row, i) : 0u;
  }
}

// SIMULATE (paper Alg. 2): where the predicate fires, the signed byte max
// of the read row; VISITED bytes of the own row stay VISITED.
struct Propagate {
  // blocks of 4 warps an SM the 16-byte path is bounded to: 80 registers
  // without spilling, measured faster on the H100 than the 4 that 102
  // registers allow; the 4-byte path would spill there and is left unbounded
  // (min_blocks16 scales it to other block shapes)
  static constexpr int kMinBlocks16 = 6;

  __device__ static uint32_t start(uint32_t own) { return own; }

  template <int PRED>
  __device__ static void step(uint32_t (&acc)[kLaneWords], uint32_t he, uint32_t le,
                              uint32_t te, const uint32_t (&words)[kLaneWords],
                              const uint32_t (&xs)[kLaneWords][4]) {
    // bytes whose edge does not fire read as VISITED, the max's identity
#pragma unroll
    for (int t = 0; t < kLaneWords; ++t)
      acc[t] = __vmaxs4(acc[t], words[t] | ~live_bytes<PRED>(he, le, te, xs[t]));
  }

  __device__ static uint32_t merge(uint32_t a, uint32_t b) { return __vmaxs4(a, b); }

  // a whole row's word from its running value and its input word
  __device__ static uint32_t finish(uint32_t acc, uint32_t prev) {
    return acc | visited_bytes(prev);
  }
};

// CASCADE (paper Alg. 3): where the predicate fires and the read register is
// VISITED, the written register becomes VISITED. The running value holds
// 0xFF in each VISITED byte (VISITED is the byte 0xFF).
struct Cascade {
  // 5 blocks an SM (at most 102 registers) on the 16-byte path: the
  // residency the cascade had unbounded at 93 registers on the H100
  static constexpr int kMinBlocks16 = 5;

  __device__ static uint32_t start(uint32_t own) { return visited_bytes(own); }

  template <int PRED>
  __device__ static void step(uint32_t (&vis)[kLaneWords], uint32_t he, uint32_t le,
                              uint32_t te, const uint32_t (&words)[kLaneWords],
                              const uint32_t (&xs)[kLaneWords][4]) {
    // VISITED bytes of the read row that the own row lacks so far; the
    // predicate only where some are
    uint32_t fresh[kLaneWords];
    bool any = false;
#pragma unroll
    for (int t = 0; t < kLaneWords; ++t) {
      fresh[t] = visited_bytes(words[t]) & ~vis[t];
      any |= fresh[t] != 0u;
    }
    if (any) {
#pragma unroll
      for (int t = 0; t < kLaneWords; ++t)
        vis[t] |= fresh[t] & live_bytes<PRED>(he, le, te, xs[t]);
    }
  }

  __device__ static uint32_t merge(uint32_t a, uint32_t b) { return a | b; }

  __device__ static uint32_t finish(uint32_t vis, uint32_t prev) { return vis | prev; }
};

// The minimum resident blocks of OP's 16-byte path at kItemWarps warps a
// block: OP::kMinBlocks16 was sized for blocks of 4 warps, so it scales by
// 4 / kItemWarps (at least 1) and the per-thread register budget stays the
// 4-warp one (80 registers for Propagate, 102 for Cascade) or grows.
template <class OP>
constexpr int min_blocks16() {
  return OP::kMinBlocks16 * 4 / kItemWarps > 0 ? OP::kMinBlocks16 * 4 / kItemWarps : 1;
}

template <class OP, int PRED, int VEC, bool IN_PLACE>
__global__ void
__launch_bounds__(kItemWarps * kWarp, VEC == 16 ? min_blocks16<OP>() : 1)
    item_sweep(const int8_t* self_in, const int8_t* __restrict__ gather, int8_t* out,
               int8_t* __restrict__ partial, const int32_t* __restrict__ item_ptr,
               const int32_t* __restrict__ item_row, const int32_t* __restrict__ item_slot,
               const int32_t* __restrict__ nbr, const uint32_t* __restrict__ h,
               const uint32_t* __restrict__ lo, const uint32_t* __restrict__ thr,
               const uint32_t* __restrict__ x, int num_items, int num_regs,
               int* __restrict__ changed) {
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const long long item = static_cast<long long>(blockIdx.x) * kItemWarps + warp;
  if (item >= num_items) return;
  const int e0 = item_ptr[item], ne = item_ptr[item + 1] - e0;
  if (IN_PLACE && ne == 0) return;  // nothing merges into the row
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem) + warp * kStages * kChunkBytes;
  const int nwords = num_regs / 4;
  const long long row = item_row[item];
  const int slot = item_slot[item];
  const int8_t* own = self_in + row * num_regs;
  int8_t* dst = slot < 0 ? out + row * num_regs
                         : partial + static_cast<long long>(slot) * num_regs;
  bool diff = false;
  for (int base = 0; base < nwords; base += kChunkWords) {
    uint32_t acc[kLaneWords];
    load_lane_words<VEC, IN_PLACE>(own, base, lane, nwords, acc);
#pragma unroll
    for (int t = 0; t < kLaneWords; ++t) acc[t] = OP::start(acc[t]);
    if (ne > 0) {
      uint32_t xs[kLaneWords][4];
      load_lane_x<VEC>(x, base, lane, nwords, xs);
      walk_edges<VEC>(gather, num_regs, base, nbr, h, lo, thr, e0, ne, ring, lane,
                      [&](uint32_t he, uint32_t le, uint32_t te,
                          const uint32_t(&words)[kLaneWords]) {
                        OP::template step<PRED>(acc, he, le, te, words, xs);
                      });
    }
#pragma unroll
    for (int t = 0; t < kLaneWords; ++t) {
      const int w = lane_word<VEC>(base, lane, t);
      if (w < nwords) {
        uint32_t res = acc[t];
        if (slot < 0) {  // the whole row: finish, compare
          const uint32_t prev = own_word<IN_PLACE>(own, w);
          res = OP::finish(res, prev);
          const bool moved = res != prev;
          diff |= moved;
          if (IN_PLACE && !moved) continue;
        }
        store_word(dst, w, res);
      }
    }
  }
  if (diff) *changed = 1;
}

// one thread per (split row, word): the row's word folded with its partials
template <class OP, bool IN_PLACE>
__global__ void item_combine(const int8_t* self_in, int8_t* out,
                             const int8_t* __restrict__ partial,
                             const int32_t* __restrict__ split_row,
                             const int32_t* __restrict__ split_ptr, int num_split,
                             int num_regs, int* __restrict__ changed) {
  const int nwords = num_regs / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(num_split) * nwords) return;
  const int k = static_cast<int>(idx / nwords), w = static_cast<int>(idx % nwords);
  const long long row = split_row[k];
  const uint32_t prev = own_word<IN_PLACE>(self_in + row * num_regs, w);
  uint32_t res = prev;
  for (int p = split_ptr[k]; p < split_ptr[k + 1]; ++p)
    res = OP::merge(res, load_word(partial + static_cast<long long>(p) * num_regs, w));
  res = OP::finish(res, prev);
  if (IN_PLACE && res == prev) return;
  store_word(out + row * num_regs, w, res);
  if (res != prev) *changed = 1;
}

// One work-item sweep of OP on `stream`: the item launch over the work list,
// then the combine launch over the split rows. The 16-byte path where the
// register count is a multiple of 16 and every matrix base (and x's) is
// 16-byte aligned, else the 4-byte one. Returns the launch status.
template <class OP, bool IN_PLACE>
int launch_item_sweep(const void* self_in, const void* gather, void* out, void* partial,
                      const void* item_ptr, const void* item_row, const void* item_slot,
                      const void* split_row, const void* split_ptr, const void* nbr,
                      const void* h, const void* lo, const void* thr, const void* x,
                      int num_items, int num_split, int num_regs, int variant,
                      void* changed, void* stream) {
  if (num_items <= 0 || num_regs <= 0) return cudaGetLastError();
  if (variant != 0 && variant != 1) return cudaErrorInvalidValue;
  if (!rows_aligned(num_regs, self_in, gather) || !rows_aligned(num_regs, out, partial) ||
      !rows_aligned(num_regs, x, x))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec16 = num_regs % 16 == 0 && aligned16(self_in) && aligned16(gather) &&
                     aligned16(out) && aligned16(partial) && aligned16(x);
  const auto p0 = vec16 ? item_sweep<OP, 0, 16, IN_PLACE> : item_sweep<OP, 0, 4, IN_PLACE>;
  const auto p1 = vec16 ? item_sweep<OP, 1, 16, IN_PLACE> : item_sweep<OP, 1, 4, IN_PLACE>;
  const auto kernel = variant == 0 ? p0 : p1;
  if (kRingBytes > kDefaultSharedBytes) {  // 8 warps: a 64 KiB ring a block
    const cudaError_t st = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
    if (st != cudaSuccess) return st;
  }
  const int blocks = (num_items + kItemWarps - 1) / kItemWarps;
  kernel<<<blocks, kItemWarps * kWarp, kRingBytes, s>>>(
      static_cast<const int8_t*>(self_in), static_cast<const int8_t*>(gather),
      static_cast<int8_t*>(out), static_cast<int8_t*>(partial),
      static_cast<const int32_t*>(item_ptr), static_cast<const int32_t*>(item_row),
      static_cast<const int32_t*>(item_slot), static_cast<const int32_t*>(nbr),
      static_cast<const uint32_t*>(h), static_cast<const uint32_t*>(lo),
      static_cast<const uint32_t*>(thr), static_cast<const uint32_t*>(x), num_items,
      num_regs, static_cast<int*>(changed));
  if (num_split > 0) {  // one thread per (split row, word)
    const long long threads = static_cast<long long>(num_split) * (num_regs / 4);
    const int block = 256;
    item_combine<OP, IN_PLACE>
        <<<static_cast<unsigned>((threads + block - 1) / block), block, 0, s>>>(
            static_cast<const int8_t*>(self_in), static_cast<int8_t*>(out),
            static_cast<const int8_t*>(partial), static_cast<const int32_t*>(split_row),
            static_cast<const int32_t*>(split_ptr), num_split, num_regs,
            static_cast<int*>(changed));
  }
  return cudaGetLastError();
}

}  // namespace rt
