// Hash-based fused edge sampling (paper §2.2, eq. (2)): the dense mask
//   out[e, r] = predicate(h[e], lo[e], thr[e], x[r])   as uint8 0 or 1.
//
// Replaces the Pallas kernel src/repro/kernels/fused_sample.py
// (fused_sample_pallas, body _fused_sample_kernel).
//
// One thread per (edge, 4-sample word): it evaluates four predicates and
// stores the four bytes as one 32-bit word, so a warp writes 128
// consecutive bytes of a row. A grid-stride loop covers any edge count.
//
// Bound on the H100: bytes, the E * R bytes of the mask written once (12
// bytes per edge and 4 per sample read). The operations (the predicate's 3
// per pair, 11 with the lt remix) come close behind for the remix form.
#include "common.cuh"

namespace {

template <int PRED>
__global__ void fused_sample_kernel(const uint32_t* __restrict__ h,
                                    const uint32_t* __restrict__ lo,
                                    const uint32_t* __restrict__ thr,
                                    const uint32_t* __restrict__ x,
                                    uint8_t* __restrict__ out,
                                    long long num_edges, int num_samples) {
  const int nwords = num_samples / 4;
  const long long total = num_edges * nwords;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long e = i / nwords;
    const int w = static_cast<int>(i - e * nwords);
    const uint32_t he = __ldg(h + e), le = __ldg(lo + e), te = __ldg(thr + e);
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (rt::live<PRED>(he, le, te, __ldg(x + w * 4 + b))) word |= 1u << (8 * b);
    reinterpret_cast<uint32_t*>(out + e * num_samples)[w] = word;
  }
}

}  // namespace

extern "C" int repro_fused_sample(const void* h, const void* lo,
                                  const void* thr, const void* x, void* out,
                                  long long num_edges, int num_samples,
                                  int variant, void* stream) {
  if (num_edges <= 0 || num_samples <= 0) return cudaGetLastError();
  if (variant != 0 && variant != 1) return cudaErrorInvalidValue;
  if (!rt::rows_aligned(num_samples, out, out)) return cudaErrorInvalidValue;
  const int threads = 256;
  const long long work = num_edges * (num_samples / 4);
  const long long want = (work + threads - 1) / threads;
  const int blocks = want < 132 * 64 ? static_cast<int>(want) : 132 * 64;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* hh = static_cast<const uint32_t*>(h);
  const auto* ll = static_cast<const uint32_t*>(lo);
  const auto* tt = static_cast<const uint32_t*>(thr);
  const auto* xx = static_cast<const uint32_t*>(x);
  auto* o = static_cast<uint8_t*>(out);
  if (variant == 0) {
    fused_sample_kernel<0><<<blocks, threads, 0, s>>>(hh, ll, tt, xx, o, num_edges,
                                                      num_samples);
  } else {
    fused_sample_kernel<1><<<blocks, threads, 0, s>>>(hh, ll, tt, xx, o, num_edges,
                                                      num_samples);
  }
  return cudaGetLastError();
}
