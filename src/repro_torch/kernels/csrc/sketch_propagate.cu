// One SIMULATE sweep (paper Alg. 2), Jacobi: for every edge (u, v) and
// register j where the predicate fires,
//   out[u, j] = max(out[u, j], m_in[v, j]),
// starting from out = m_in, with VISITED entries of m_in kept.
//
// Replaces the Pallas kernel src/repro/kernels/sketch_propagate.py
// (propagate_sweep_pallas, body _propagate_kernel).
//
// The sweep writes source rows, and CUDA has no 8-bit atomicMax. So the
// edges come in a source-ordered copy with row pointers (made once per
// build, kernels/edges.py), and one warp owns each source row u: it walks
// u's out-edges, gathers m_in[v, :] with coalesced 32-bit loads, keeps the
// running max in registers (__vmaxs4: four signed bytes at once) and writes
// out[u, :] once. No atomics, no races; the result does not depend on the
// edge order. A lane holds WORDS words of the row, so a warp covers
// 32 * WORDS * 4 registers per pass over the edges (1024 for WORDS = 8).
//
// Bound on the H100: integer operations. Each sweep evaluates the predicate
// E * J times (3 operations each for the interval form, 11 with the lt
// remix, plus the max), against compulsory bytes of about 2 * n * J + 20 E.
// The gathers of m_in[v, :] are the memory traffic the kernel actually
// makes (E * J bytes, mostly from device memory at large n).
//
// Known imbalance: a warp walks its row's out-edges alone, so an R-MAT hub
// with tens of thousands of out-edges keeps one warp busy while the rest of
// the card idles. The changed flag is set when any output word differs
// from its input word (the host reads it once per sweep).
#include "common.cuh"

namespace {

constexpr int kWords = 8;

template <int PRED>
__global__ void propagate_kernel(const int8_t* __restrict__ m_in,
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
    uint32_t acc[kWords], xs[kWords][4];
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int w = base + k * rt::kWarp + lane;
      const bool act = w < nwords;
      acc[k] = act ? rt::load_word(in_row, w) : 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) xs[k][b] = act ? __ldg(x + w * 4 + b) : 0u;
    }
    for (int e = e0; e < e1; ++e) {
      const int8_t* v_row = m_in + static_cast<long long>(__ldg(nbr + e)) * num_regs;
      const uint32_t he = __ldg(h + e), le = __ldg(lo + e), te = __ldg(thr + e);
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const int w = base + k * rt::kWarp + lane;
        if (w < nwords) {
          uint32_t live = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (rt::live<PRED>(he, le, te, xs[k][b])) live |= 0xFFu << (8 * b);
          // bytes whose edge is not live read as VISITED, the max identity
          acc[k] = __vmaxs4(acc[k], rt::load_word(v_row, w) | ~live);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int w = base + k * rt::kWarp + lane;
      if (w < nwords) {
        const uint32_t prev = rt::load_word(in_row, w);
        // VISITED stays sticky
        const uint32_t res = acc[k] | rt::visited_bytes(prev);
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
  propagate_kernel<PRED><<<blocks, threads, 0, s>>>(
      static_cast<const int8_t*>(m_in), static_cast<int8_t*>(out),
      static_cast<const int32_t*>(rowptr), static_cast<const int32_t*>(nbr),
      static_cast<const uint32_t*>(h), static_cast<const uint32_t*>(lo),
      static_cast<const uint32_t*>(thr), static_cast<const uint32_t*>(x),
      n_rows, num_regs, static_cast<int*>(changed));
}

}  // namespace

extern "C" int repro_propagate_sweep(const void* m_in, void* out,
                                     const void* rowptr, const void* nbr,
                                     const void* h, const void* lo,
                                     const void* thr, const void* x,
                                     int n_rows, int num_regs, int variant,
                                     void* changed, void* stream) {
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
