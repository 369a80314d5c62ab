// One CASCADE sweep (paper Alg. 3), Jacobi: for every edge (u, v) and
// register j where the predicate fires and m_in[u, j] is VISITED,
//   out[v, j] = VISITED,
// starting from out = m_in.
//
// Replaces the Pallas kernel src/repro/kernels/cascade_step.py
// (cascade_sweep_pallas, body _cascade_kernel).
//
// The sweep writes destination rows, and the serving edge order is already
// sorted by destination, so one warp owns each destination row v: it walks
// v's in-edges (row pointers made once per build, kernels/edges.py), reads
// m_in[u, :] with coalesced 32-bit loads, and evaluates the predicate only
// for words of u that hold a VISITED byte. It writes out[v, :] once and
// sets the changed flag when a register became VISITED.
//
// Bound on the H100: bytes (2 * n * J for the matrix plus 16 bytes per
// edge). The operations are one VISITED test per (edge, 4-register word)
// and the predicate only on (edge, register) pairs whose source register is
// VISITED, so they depend on how far the cascade has spread and stay below
// the bytes term in a typical sweep.
#include "common.cuh"

namespace {

constexpr int kWords = 8;

template <int PRED>
__global__ void cascade_kernel(const int8_t* __restrict__ m_in,
                               int8_t* __restrict__ out,
                               const int32_t* __restrict__ rowptr,
                               const int32_t* __restrict__ nbr,
                               const uint32_t* __restrict__ h,
                               const uint32_t* __restrict__ lo,
                               const uint32_t* __restrict__ thr,
                               const uint32_t* __restrict__ x, int n_rows,
                               int num_regs, int* __restrict__ changed) {
  const int lane = threadIdx.x % rt::kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / rt::kWarp) +
      threadIdx.x / rt::kWarp;
  if (row >= n_rows) return;
  const int nwords = num_regs / 4;
  const int8_t* in_row = m_in + row * num_regs;
  int8_t* out_row = out + row * num_regs;
  const int e0 = rowptr[row], e1 = rowptr[row + 1];
  bool diff = false;
  for (int base = 0; base < nwords; base += rt::kWarp * kWords) {
    uint32_t vis[kWords], xs[kWords][4];
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int w = base + k * rt::kWarp + lane;
      const bool act = w < nwords;
      vis[k] = act ? rt::visited_bytes(rt::load_word(in_row, w)) : 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) xs[k][b] = act ? __ldg(x + w * 4 + b) : 0u;
    }
    for (int e = e0; e < e1; ++e) {
      const int8_t* u_row = m_in + static_cast<long long>(__ldg(nbr + e)) * num_regs;
      const uint32_t he = __ldg(h + e), le = __ldg(lo + e), te = __ldg(thr + e);
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const int w = base + k * rt::kWarp + lane;
        if (w < nwords) {
          const uint32_t src_vis = rt::visited_bytes(rt::load_word(u_row, w));
          if (src_vis & ~vis[k]) {
            uint32_t live = 0;
#pragma unroll
            for (int b = 0; b < 4; ++b)
              if (rt::live<PRED>(he, le, te, xs[k][b])) live |= 0xFFu << (8 * b);
            vis[k] |= src_vis & live;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int w = base + k * rt::kWarp + lane;
      if (w < nwords) {
        const uint32_t prev = rt::load_word(in_row, w);
        const uint32_t res = prev | vis[k];  // VISITED is the byte 0xFF
        diff |= res != prev;
        rt::store_word(out_row, w, res);
      }
    }
  }
  if (diff) *changed = 1;
}

template <int PRED>
void launch(const void* m_in, void* out, const void* rowptr, const void* nbr,
            const void* h, const void* lo, const void* thr, const void* x,
            int n_rows, int num_regs, void* changed, cudaStream_t s) {
  const int threads = 256;
  const int rows_per_block = threads / rt::kWarp;
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  cascade_kernel<PRED><<<blocks, threads, 0, s>>>(
      static_cast<const int8_t*>(m_in), static_cast<int8_t*>(out),
      static_cast<const int32_t*>(rowptr), static_cast<const int32_t*>(nbr),
      static_cast<const uint32_t*>(h), static_cast<const uint32_t*>(lo),
      static_cast<const uint32_t*>(thr), static_cast<const uint32_t*>(x),
      n_rows, num_regs, static_cast<int*>(changed));
}

}  // namespace

extern "C" int repro_cascade_sweep(const void* m_in, void* out,
                                   const void* rowptr, const void* nbr,
                                   const void* h, const void* lo,
                                   const void* thr, const void* x, int n_rows,
                                   int num_regs, int variant, void* changed,
                                   void* stream) {
  if (n_rows <= 0 || num_regs <= 0) return cudaGetLastError();
  if (variant != 0 && variant != 1) return cudaErrorInvalidValue;
  if (!rt::rows_aligned(num_regs, m_in, out)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    launch<0>(m_in, out, rowptr, nbr, h, lo, thr, x, n_rows, num_regs, changed, s);
  } else {
    launch<1>(m_in, out, rowptr, nbr, h, lo, thr, x, n_rows, num_regs, changed, s);
  }
  return cudaGetLastError();
}
