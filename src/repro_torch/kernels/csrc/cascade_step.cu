// One CASCADE sweep (paper Alg. 3), Jacobi: for every edge (u, v) and
// register j where the predicate fires and m_in[u, j] is VISITED,
//   out[v, j] = VISITED,
// starting from out = m_in.
//
// Replaces the Pallas kernel src/repro/kernels/cascade_step.py
// (cascade_sweep_pallas, body _cascade_kernel).
//
// Bound on the H100: bytes (2 * n * J for the matrix plus 16 bytes per
// edge). The operations are one VISITED test per (edge, 4-register word)
// and the predicate only on (edge, register) pairs whose source register is
// VISITED, so they depend on how far the cascade has spread and stay below
// the bytes term in a typical sweep. The kernel itself gathers m_in[u, :]
// for every edge, E * J bytes, from device memory or from L2. There is no
// product, so the tensor cores have no part in it.
//
// The sweep writes destination rows; the edges come grouped by destination
// row and cut into work items of at most CHUNK edges (kernels/edges.py, made
// once per build), so R-MAT's in-degree hubs (39,415 edges at rmat:20) no
// longer set the sweep's length:
//  1. one warp takes one item (common.cuh, walk_edges): it gathers each
//     edge's m_in[u, :] into a shared-memory ring by cp.async ahead of the
//     walk, and a lane evaluates the predicate only where u holds a VISITED
//     byte that v's row lacks so far;
//  2. an item that is its whole row writes out[v, :] and the changed flag;
//     an item of a split row writes its VISITED bytes to its own partial
//     slot;
//  3. a second launch ORs each split row's partials into m_in[v, :], writes
//     out[v, :] and sets the flag. OR is commutative, associative and
//     idempotent, so any split gives the same bytes; no atomics.
#include "common.cuh"

namespace {

template <int PRED, int VEC>
__global__ void __launch_bounds__(rt::kItemWarps * rt::kWarp)
    cascade_items(const int8_t* __restrict__ m_in, int8_t* __restrict__ out,
                  int8_t* __restrict__ partial, const int32_t* __restrict__ item_ptr,
                  const int32_t* __restrict__ item_row,
                  const int32_t* __restrict__ item_slot, const int32_t* __restrict__ nbr,
                  const uint32_t* __restrict__ h, const uint32_t* __restrict__ lo,
                  const uint32_t* __restrict__ thr, const uint32_t* __restrict__ x,
                  int num_items, int num_regs, int* __restrict__ changed) {
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
    uint32_t vis[rt::kLaneWords];
    rt::load_lane_words<VEC>(in_row, base, lane, nwords, vis);
#pragma unroll
    for (int t = 0; t < rt::kLaneWords; ++t) vis[t] = rt::visited_bytes(vis[t]);
    if (ne > 0) {
      uint32_t xs[rt::kLaneWords][4];
      rt::load_lane_x<VEC>(x, base, lane, nwords, xs);
      rt::walk_edges<VEC>(
          m_in, num_regs, base, nbr, h, lo, thr, e0, ne, ring, lane,
          [&](uint32_t he, uint32_t le, uint32_t te,
              const uint32_t(&words)[rt::kLaneWords]) {
            // VISITED bytes of u that v's row lacks so far; the predicate
            // only where some are
            uint32_t fresh[rt::kLaneWords];
            bool any = false;
#pragma unroll
            for (int t = 0; t < rt::kLaneWords; ++t) {
              fresh[t] = rt::visited_bytes(words[t]) & ~vis[t];
              any |= fresh[t] != 0u;
            }
            if (any) {
#pragma unroll
              for (int t = 0; t < rt::kLaneWords; ++t)
                vis[t] |= fresh[t] & rt::live_bytes<PRED>(he, le, te, xs[t]);
            }
          });
    }
#pragma unroll
    for (int t = 0; t < rt::kLaneWords; ++t) {
      const int w = rt::lane_word<VEC>(base, lane, t);
      if (w < nwords) {
        uint32_t res = vis[t];
        if (slot < 0) {  // the whole row; VISITED is the byte 0xFF
          const uint32_t prev = rt::load_word(in_row, w);
          res |= prev;
          diff |= res != prev;
        }
        rt::store_word(dst, w, res);
      }
    }
  }
  if (diff) *changed = 1;
}

// one thread per (split row, word): m_in's word OR the row's partials
__global__ void cascade_combine(const int8_t* __restrict__ m_in, int8_t* __restrict__ out,
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
    res |= rt::load_word(partial + static_cast<long long>(p) * num_regs, w);
  rt::store_word(out + row * num_regs, w, res);
  if (res != prev) *changed = 1;
}

}  // namespace

extern "C" int repro_cascade_sweep(const void* m_in, void* out, void* partial,
                                   const void* item_ptr, const void* item_row,
                                   const void* item_slot, const void* split_row,
                                   const void* split_ptr, const void* nbr, const void* h,
                                   const void* lo, const void* thr, const void* x,
                                   int num_items, int num_split, int num_regs,
                                   int variant, void* changed, void* stream) {
  static const rt::ItemKernel items[2][2] = {
      {cascade_items<0, 4>, cascade_items<0, 16>},
      {cascade_items<1, 4>, cascade_items<1, 16>}};
  return rt::launch_item_sweep(items, cascade_combine, m_in, out, partial, item_ptr,
                               item_row, item_slot, split_row, split_ptr, nbr, h, lo,
                               thr, x, num_items, num_split, num_regs, variant, changed,
                               stream);
}
