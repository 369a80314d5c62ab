// Per-row cardinality statistics: stat[u] = sum over valid j of 2^-M[u, j],
// count[u] = number of valid j (valid: M[u, j] != VISITED). Output is
// float32[2, n_rows]: row 0 the statistic, row 1 the count.
//
// Replaces the Pallas kernel src/repro/kernels/sketch_cardinality.py
// (cardinality_stats_pallas, body _cardinality_kernel).
//
// Exactness: the sum is taken in integers, as the sum of 2^(32 - M) in a
// uint64 (at most 2^43 for 2048 registers), rounded once to float32 and
// scaled by 2^-32. The order of the sum then does not matter, and the
// plain version (kernels/sketch_cardinality.py) gives the same bits.
//
// Bound on the H100: bytes (one read of the matrix, a few integer operations
// per byte). Design: one warp per row, 32-bit coalesced loads, a shuffle
// reduction at the end.
#include "common.cuh"

namespace {

__global__ void cardinality_kernel(const int8_t* __restrict__ m,
                                   float* __restrict__ out, int n_rows,
                                   int num_regs) {
  const int lane = threadIdx.x % rt::kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / rt::kWarp) +
      threadIdx.x / rt::kWarp;
  if (row >= n_rows) return;
  const int8_t* m_row = m + row * num_regs;
  const int nwords = num_regs / 4;
  unsigned long long sum = 0;
  unsigned count = 0;
  for (int w = lane; w < nwords; w += rt::kWarp) {
    const uint32_t v = rt::load_word(m_row, w);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int reg = static_cast<int8_t>((v >> (8 * b)) & 0xFFu);
      if (reg != -1) {
        sum += 1ull << (32 - reg);
        ++count;
      }
    }
  }
#pragma unroll
  for (int d = rt::kWarp / 2; d > 0; d /= 2) {
    sum += __shfl_down_sync(0xFFFFFFFFu, sum, d);
    count += __shfl_down_sync(0xFFFFFFFFu, count, d);
  }
  if (lane == 0) {
    out[row] = __ull2float_rn(sum) * 0x1p-32f;
    out[n_rows + row] = static_cast<float>(count);
  }
}

}  // namespace

extern "C" int repro_cardinality_stats(const void* m, void* out, int n_rows,
                                       int num_regs, void* stream) {
  if (n_rows <= 0 || num_regs <= 0) return cudaGetLastError();
  const int threads = 256;
  const int rows_per_block = threads / rt::kWarp;
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const int8_t*>(m);
  auto* o = static_cast<float*>(out);
  if (!rt::rows_aligned(num_regs, m, m)) return cudaErrorInvalidValue;
  cardinality_kernel<<<blocks, threads, 0, s>>>(in, o, n_rows, num_regs);
  return cudaGetLastError();
}
