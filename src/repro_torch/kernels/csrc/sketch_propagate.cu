// One SIMULATE sweep (paper Alg. 2), Jacobi: for every edge (u, v) and
// register j where the predicate fires,
//   out[u, j] = max(out[u, j], m_in[v, j]),
// starting from out = m_in, with VISITED entries of m_in kept.
//
// Replaces the Pallas kernel src/repro/kernels/sketch_propagate.py
// (propagate_sweep_pallas, body _propagate_kernel).
//
// Bound on the H100: integer operations. Each sweep evaluates the predicate
// E * J times (3 operations each for the interval form, 11 with the lt
// remix, plus the max), against compulsory bytes of about 2 * n * J + 20 E.
// The gathers of m_in[v, :] are the memory traffic the kernel actually
// makes: E * J bytes, from device memory or, for rows many edges read (the
// R-MAT hubs), from L2. The work is a 32-bit hash compare and a byte max,
// with no product, so the tensor cores have no part in it.
//
// The sweep writes source rows, and CUDA has no 8-bit atomicMax, so the
// edges come grouped by source row and cut into work items of at most CHUNK
// edges (kernels/edges.py, made once per build). R-MAT's out-degrees are
// skewed (at rmat:20 the largest is 39,935, half the rows have none); a warp
// per row would make the hub's walk the sweep's length. Here:
//  1. one warp takes one item (common.cuh, walk_edges): it gathers each
//     edge's m_in[v, :] into a shared-memory ring by cp.async ahead of the
//     walk, keeps the running max in registers (__vmaxs4: four signed bytes
//     at once; a byte whose edge does not fire reads as VISITED, the max's
//     identity) and writes its result once;
//  2. an item that is its whole row writes out[u, :] and the changed flag;
//     an item of a split row writes its partial row (m_in[u, :] merged with
//     its edges) to its own slot of a scratch the wrapper allocates;
//  3. a second launch merges each split row's partials (the max is
//     commutative, associative and idempotent, so any split of a row's edges
//     gives the same bytes), keeps VISITED, writes out[u, :] and sets the
//     flag. No atomics: the result is deterministic.
// The changed flag is set when any output word differs from its input word
// (the host reads it once per sweep).
#include "common.cuh"

namespace {

// On the 16-byte path the kernel fits 80 registers without spilling, which
// lets 6 blocks (24 warps) share an SM, measured faster on the H100 than
// the 4 that 102 registers allow; the 4-byte path would spill there and is
// left unbounded.
template <int PRED, int VEC>
__global__ void __launch_bounds__(rt::kItemWarps * rt::kWarp, VEC == 16 ? 6 : 1)
    propagate_items(const int8_t* __restrict__ m_in, int8_t* __restrict__ out,
                    int8_t* __restrict__ partial, const int32_t* __restrict__ item_ptr,
                    const int32_t* __restrict__ item_row,
                    const int32_t* __restrict__ item_slot,
                    const int32_t* __restrict__ nbr, const uint32_t* __restrict__ h,
                    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ thr,
                    const uint32_t* __restrict__ x, int num_items, int num_regs,
                    int* __restrict__ changed) {
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x % rt::kWarp, warp = threadIdx.x / rt::kWarp;
  const long long item = static_cast<long long>(blockIdx.x) * rt::kItemWarps + warp;
  if (item >= num_items) return;
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem) + warp * rt::kStages * rt::kChunkBytes;
  const int nwords = num_regs / 4;
  const long long row = item_row[item];
  const int slot = item_slot[item];
  const int e0 = item_ptr[item], ne = item_ptr[item + 1] - e0;
  const int8_t* in_row = m_in + row * num_regs;
  int8_t* dst = slot < 0 ? out + row * num_regs
                         : partial + static_cast<long long>(slot) * num_regs;
  bool diff = false;
  for (int base = 0; base < nwords; base += rt::kChunkWords) {
    uint32_t acc[rt::kLaneWords];
    rt::load_lane_words<VEC>(in_row, base, lane, nwords, acc);
    if (ne > 0) {
      uint32_t xs[rt::kLaneWords][4];
      rt::load_lane_x<VEC>(x, base, lane, nwords, xs);
      rt::walk_edges<VEC>(
          m_in, num_regs, base, nbr, h, lo, thr, e0, ne, ring, lane,
          [&](uint32_t he, uint32_t le, uint32_t te,
              const uint32_t(&words)[rt::kLaneWords]) {
#pragma unroll
            for (int t = 0; t < rt::kLaneWords; ++t)
              acc[t] = __vmaxs4(acc[t],
                                words[t] | ~rt::live_bytes<PRED>(he, le, te, xs[t]));
          });
    }
#pragma unroll
    for (int t = 0; t < rt::kLaneWords; ++t) {
      const int w = rt::lane_word<VEC>(base, lane, t);
      if (w < nwords) {
        uint32_t res = acc[t];
        if (slot < 0) {  // the whole row: keep VISITED, compare
          const uint32_t prev = rt::load_word(in_row, w);
          res |= rt::visited_bytes(prev);
          diff |= res != prev;
        }
        rt::store_word(dst, w, res);
      }
    }
  }
  if (diff) *changed = 1;
}

// one thread per (split row, word): the max of the row's partials, VISITED
// kept
__global__ void propagate_combine(const int8_t* __restrict__ m_in, int8_t* __restrict__ out,
                                  const int8_t* __restrict__ partial,
                                  const int32_t* __restrict__ split_row,
                                  const int32_t* __restrict__ split_ptr, int num_split,
                                  int num_regs, int* __restrict__ changed) {
  const int nwords = num_regs / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(num_split) * nwords) return;
  const int k = static_cast<int>(idx / nwords), w = static_cast<int>(idx % nwords);
  const long long row = split_row[k];
  const uint32_t prev = rt::load_word(m_in + row * num_regs, w);
  uint32_t res = prev;
  for (int p = split_ptr[k]; p < split_ptr[k + 1]; ++p)
    res = __vmaxs4(res, rt::load_word(partial + static_cast<long long>(p) * num_regs, w));
  res |= rt::visited_bytes(prev);
  rt::store_word(out + row * num_regs, w, res);
  if (res != prev) *changed = 1;
}

}  // namespace

extern "C" int repro_propagate_sweep(const void* m_in, void* out, void* partial,
                                     const void* item_ptr, const void* item_row,
                                     const void* item_slot, const void* split_row,
                                     const void* split_ptr, const void* nbr,
                                     const void* h, const void* lo, const void* thr,
                                     const void* x, int num_items, int num_split,
                                     int num_regs, int variant, void* changed,
                                     void* stream) {
  static const rt::ItemKernel items[2][2] = {
      {propagate_items<0, 4>, propagate_items<0, 16>},
      {propagate_items<1, 4>, propagate_items<1, 16>}};
  return rt::launch_item_sweep(items, propagate_combine, m_in, out, partial, item_ptr,
                               item_row, item_slot, split_row, split_ptr, nbr, h, lo,
                               thr, x, num_items, num_split, num_regs, variant, changed,
                               stream);
}
