// Ring-step bucket merges of the serial-ring backend, in place on acc:
//
//   propagate: for every live slot (w, r) of a bucket and register j where
//              the predicate fires, acc[w, j] = max(acc[w, j], block[r, j]);
//              VISITED entries of acc stay VISITED (sticky);
//   cascade:   where the predicate fires and block[r, j] is VISITED,
//              acc[w, j] = VISITED.
//
// The propagate merge replaces the Pallas kernel
// src/repro/kernels/bucket_propagate.py (bucket_propagate_pallas, body
// _bucket_kernel). The cascade merge is the twin the reference computes in
// jnp (core/distributed.py, _bucket_sweep_cascade) and numpy
// (partition/serial.py, _RingState.sweep_cascade); it has no Pallas kernel.
//
// A bucket's slots come grouped by write row w, as compressed rows made once
// per partition on the device (partition/serial.py, kernels/edges.py), with
// the padding slots dropped, and cut into work items of at most CHUNK slots
// (kernels/edges.py, WorkList). acc and block must not share memory (the
// wrappers check it). The changed flag is set when any word of acc changed.
//
// cascade: items.cuh's work-item sweep in place (rt::item_sweep,
// rt::Cascade, IN_PLACE: self_in = out = acc, gather = block). A warp takes
// an item of the bucket's list, so no bucket row (an R-MAT hub, 13 K slots
// at rmat:20) sets the launch's length; an item without slots (about two
// rows in three of a bucket) returns at once; split rows' VISITED bytes go
// through the partial scratch and the combine launch, which ORs them into
// acc. Bound on the H100: bytes (one VISITED test per (slot, 4-register
// word), the predicate only where the read register is VISITED); the
// kernel's own traffic is the gathers, slots x num_regs bytes.
//
// propagate: one warp owns each write row: it reads acc[w, :] once, walks
// w's slots, gathers block[r, :] with coalesced 32-bit loads (four
// registers a word), and writes back only the words that changed. No
// atomics, no races. Bound on the H100: integer operations (the predicate
// on every (slot, register) pair). A warp walks its row's slots alone, so a
// bucket lasts as long as its longest row.
#include "items.cuh"

namespace {

constexpr int kWords = 8;

template <int PRED>
__global__ void bucket_propagate_kernel(int8_t* __restrict__ acc,
                                        const int8_t* __restrict__ block,
                                        const int32_t* __restrict__ rowptr,
                                        const int32_t* __restrict__ nbr,
                                        const uint32_t* __restrict__ h,
                                        const uint32_t* __restrict__ lo,
                                        const uint32_t* __restrict__ thr,
                                        const uint32_t* __restrict__ x,
                                        int n_rows, int num_regs,
                                        int* __restrict__ changed) {
  const int lane = threadIdx.x % rt::kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / rt::kWarp) +
      threadIdx.x / rt::kWarp;
  if (row >= n_rows) return;
  const int e0 = rowptr[row], e1 = rowptr[row + 1];
  if (e0 == e1) return;
  const int nwords = num_regs / 4;
  int8_t* acc_row = acc + row * num_regs;
  bool diff = false;
  for (int base = 0; base < nwords; base += rt::kWarp * kWords) {
    uint32_t prev[kWords], cur[kWords], xs[kWords][4];
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int w = base + k * rt::kWarp + lane;
      const bool act = w < nwords;
      prev[k] = act ? reinterpret_cast<const uint32_t*>(acc_row)[w] : 0u;
      cur[k] = prev[k];
#pragma unroll
      for (int b = 0; b < 4; ++b) xs[k][b] = act ? __ldg(x + w * 4 + b) : 0u;
    }
    for (int e = e0; e < e1; ++e) {
      const int8_t* r_row = block + static_cast<long long>(__ldg(nbr + e)) * num_regs;
      const uint32_t he = __ldg(h + e), le = __ldg(lo + e), te = __ldg(thr + e);
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const int w = base + k * rt::kWarp + lane;
        if (w < nwords) {
          uint32_t live = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (rt::live<PRED>(he, le, te, xs[k][b])) live |= 0xFFu << (8 * b);
          // bytes whose slot is not live read as VISITED, the max identity
          cur[k] = __vmaxs4(cur[k], rt::load_word(r_row, w) | ~live);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int w = base + k * rt::kWarp + lane;
      const uint32_t res = cur[k] | rt::visited_bytes(prev[k]);  // sticky
      if (w < nwords && res != prev[k]) {
        rt::store_word(acc_row, w, res);
        diff = true;
      }
    }
  }
  if (diff) *changed = 1;
}

template <int PRED>
void launch_propagate(void* acc, const void* block, const void* rowptr, const void* nbr,
                      const void* h, const void* lo, const void* thr, const void* x,
                      int n_rows, int num_regs, void* changed, cudaStream_t s) {
  const int threads = 256;
  const int rows_per_block = threads / rt::kWarp;
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  bucket_propagate_kernel<PRED><<<blocks, threads, 0, s>>>(
      static_cast<int8_t*>(acc), static_cast<const int8_t*>(block),
      static_cast<const int32_t*>(rowptr), static_cast<const int32_t*>(nbr),
      static_cast<const uint32_t*>(h), static_cast<const uint32_t*>(lo),
      static_cast<const uint32_t*>(thr), static_cast<const uint32_t*>(x),
      n_rows, num_regs, static_cast<int*>(changed));
}

}  // namespace

extern "C" int repro_bucket_propagate(void* acc, const void* block,
                                      const void* rowptr, const void* nbr,
                                      const void* h, const void* lo,
                                      const void* thr, const void* x,
                                      int n_rows, int num_regs, int variant,
                                      void* changed, void* stream) {
  if (n_rows <= 0 || num_regs <= 0) return cudaGetLastError();
  if (variant != 0 && variant != 1) return cudaErrorInvalidValue;
  if (!rt::rows_aligned(num_regs, acc, block)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    launch_propagate<0>(acc, block, rowptr, nbr, h, lo, thr, x, n_rows, num_regs,
                        changed, s);
  } else {
    launch_propagate<1>(acc, block, rowptr, nbr, h, lo, thr, x, n_rows, num_regs,
                        changed, s);
  }
  return cudaGetLastError();
}

extern "C" int repro_bucket_cascade(void* acc, const void* block, void* partial,
                                    const void* item_ptr, const void* item_row,
                                    const void* item_slot, const void* split_row,
                                    const void* split_ptr, const void* nbr, const void* h,
                                    const void* lo, const void* thr, const void* x,
                                    int num_items, int num_split, int num_regs,
                                    int variant, void* changed, void* stream) {
  return rt::launch_item_sweep<rt::Cascade, true>(
      acc, block, acc, partial, item_ptr, item_row, item_slot, split_row, split_ptr, nbr,
      h, lo, thr, x, num_items, num_split, num_regs, variant, changed, stream);
}
