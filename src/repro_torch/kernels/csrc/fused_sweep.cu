// num_sweeps Jacobi SIMULATE sweeps in one launch: each sweep, for every
// slot (w, r) and register j where the predicate fires,
//   next[w, j] = max(next[w, j], cur[r, j]),
// starting from next = cur, VISITED entries kept; the first sweep reads
// m_in, the last one writes out.
//
// Replaces the Pallas kernel src/repro/kernels/fused_sweep.py
// (fused_sweep_pallas, body _fused_sweep_kernel), which keeps an
// (n_pad, lane_tile) pane in VMEM across the sweeps. One sim shard's block
// at full width is 256 MiB, far beyond an SM, so the design here is another:
// every register column of a Jacobi sweep depends on that column alone, so a
// thread block that owns a slab of kSlabWords words (4 registers each) of
// every row can run all the sweeps on its own. Its threads split the rows
// (kSlabWords lanes per row, one word each), walk each row's slots (rows
// grouped by write row w, made once per partition), and write the row's
// slab once per sweep. Between sweeps: __syncthreads(), which makes the
// block's global writes visible to the whole block, and a ping-pong pair in
// device memory (out and scratch, chosen so that the last sweep lands in
// out). No grid-wide sync and no cooperative launch. Loads of the ping-pong
// buffers are plain (coherent) loads, never __ldg: they were written during
// this launch.
//
// Bound on the H100: integer operations (the predicate on every (slot,
// register) pair of every sweep), against compulsory bytes of one read of
// m_in, one write of out and the slots. The grid is only num_regs / 16
// blocks wide (32 at 512 registers), so the card is far from full; each
// block walks every slot of the bucket once per sweep.
#include "common.cuh"

namespace {

constexpr int kSlabWords = 4;
constexpr int kThreads = 1024;

__device__ __forceinline__ uint32_t plain_word(const int8_t* row, int w) {
  return reinterpret_cast<const uint32_t*>(row)[w];
}

template <int PRED>
__global__ void __launch_bounds__(kThreads)
fused_sweep_kernel(const int8_t* m_in, int8_t* out, int8_t* scratch,
                   const int32_t* __restrict__ rowptr,
                   const int32_t* __restrict__ nbr,
                   const uint32_t* __restrict__ h,
                   const uint32_t* __restrict__ lo,
                   const uint32_t* __restrict__ thr,
                   const uint32_t* __restrict__ x, int n_rows, int num_regs,
                   int num_sweeps) {
  const int nwords = num_regs / 4;
  const int w = blockIdx.x * kSlabWords + threadIdx.x % kSlabWords;
  const bool active = w < nwords;
  const int rows_per_pass = blockDim.x / kSlabWords;
  uint32_t xs[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) xs[b] = active ? __ldg(x + w * 4 + b) : 0u;
  for (int sweep = 0; sweep < num_sweeps; ++sweep) {
    // sweep i writes `out` when num_sweeps - 1 - i is even, else `scratch`,
    // and reads what sweep i - 1 wrote (m_in for the first)
    const int8_t* cur = sweep == 0 ? m_in
                        : ((num_sweeps - sweep) % 2 == 0 ? out : scratch);
    int8_t* next = (num_sweeps - 1 - sweep) % 2 == 0 ? out : scratch;
    if (active) {
      for (long long row = threadIdx.x / kSlabWords; row < n_rows;
           row += rows_per_pass) {
        const uint32_t prev = plain_word(cur + row * num_regs, w);
        uint32_t acc = prev;
        const int e1 = __ldg(rowptr + row + 1);
        for (int e = __ldg(rowptr + row); e < e1; ++e) {
          const uint32_t he = __ldg(h + e), le = __ldg(lo + e), te = __ldg(thr + e);
          uint32_t live = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (rt::live<PRED>(he, le, te, xs[b])) live |= 0xFFu << (8 * b);
          if (live) {
            const int8_t* r_row =
                cur + static_cast<long long>(__ldg(nbr + e)) * num_regs;
            acc = __vmaxs4(acc, plain_word(r_row, w) | ~live);
          }
        }
        rt::store_word(next + row * num_regs, w, acc | rt::visited_bytes(prev));
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int repro_fused_sweep(const void* m_in, void* out, void* scratch,
                                 const void* rowptr, const void* nbr,
                                 const void* h, const void* lo, const void* thr,
                                 const void* x, int n_rows, int num_regs,
                                 int variant, int num_sweeps, void* stream) {
  if (n_rows <= 0 || num_regs <= 0 || num_sweeps <= 0) return cudaGetLastError();
  if (variant != 0 && variant != 1) return cudaErrorInvalidValue;
  if (!rt::rows_aligned(num_regs, m_in, out)) return cudaErrorInvalidValue;
  if (num_sweeps > 1 && !rt::rows_aligned(num_regs, scratch, scratch))
    return cudaErrorInvalidValue;
  const int nwords = num_regs / 4;
  const int blocks = (nwords + kSlabWords - 1) / kSlabWords;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const int8_t*>(m_in);
  auto* o = static_cast<int8_t*>(out);
  auto* sc = static_cast<int8_t*>(scratch);
  const auto* rp = static_cast<const int32_t*>(rowptr);
  const auto* nb = static_cast<const int32_t*>(nbr);
  const auto* hh = static_cast<const uint32_t*>(h);
  const auto* ll = static_cast<const uint32_t*>(lo);
  const auto* tt = static_cast<const uint32_t*>(thr);
  const auto* xx = static_cast<const uint32_t*>(x);
  if (variant == 0) {
    fused_sweep_kernel<0><<<blocks, kThreads, 0, s>>>(in, o, sc, rp, nb, hh, ll, tt,
                                                      xx, n_rows, num_regs, num_sweeps);
  } else {
    fused_sweep_kernel<1><<<blocks, kThreads, 0, s>>>(in, o, sc, rp, nb, hh, ll, tt,
                                                      xx, n_rows, num_regs, num_sweeps);
  }
  return cudaGetLastError();
}
