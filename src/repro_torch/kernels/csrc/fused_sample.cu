// Hash-based fused edge sampling (paper §2.2, eq. (2)): the dense mask
//   out[e, r] = predicate(h[e], lo[e], thr[e], x[r])   as uint8 0 or 1.
//
// Replaces the Pallas kernel src/repro/kernels/fused_sample.py
// (fused_sample_pallas, body _fused_sample_kernel).
//
// A thread owns one column chunk of VEC samples: 16 where the sample count
// is a multiple of 16 and the mask's base 16-byte aligned, else 4. It keeps
// the chunk's VEC x values in registers for the whole launch and walks the
// edges with a stride, kUnroll edges a step (their operands loaded before
// any is evaluated), storing VEC bytes an edge: one 16-byte (or 4-byte)
// streaming store, st.global.cs, since the mask is read once, by
// core/fasst.py's OR. The R / VEC threads of one edge are consecutive, so a
// warp's stores cover whole consecutive rows. A thread divides once, to
// find its chunk and its first edge; the walk only adds.
//
// Bound on the H100: bytes, the E * R bytes of the mask written once (12
// bytes per edge and 4 per sample read). The operations (the predicate's 3
// per pair, 11 with the lt remix, and the byte packing) come close behind,
// and bound the remix form.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// byte b of the result is 1 where the edge samples x[b]
template <int PRED>
__device__ __forceinline__ uint32_t sample_word(uint32_t h, uint32_t lo, uint32_t thr,
                                                const uint32_t* xs) {
  uint32_t word = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    word |= static_cast<uint32_t>(rt::live<PRED>(h, lo, thr, xs[b])) << (8 * b);
  return word;
}

template <int PRED, int VEC>
__global__ void __launch_bounds__(kThreads)
    fused_sample_kernel(const uint32_t* __restrict__ h, const uint32_t* __restrict__ lo,
                        const uint32_t* __restrict__ thr, const uint32_t* __restrict__ x,
                        uint8_t* __restrict__ out, long long num_edges, int num_samples) {
  const int nchunks = num_samples / VEC;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // whole edges per pass of the grid: the lanes past them stay idle
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x / nchunks;
  if (tid >= stride * nchunks) return;
  const int chunk = static_cast<int>(tid % nchunks);
  uint32_t xs[VEC];
#pragma unroll
  for (int b = 0; b < VEC; ++b) xs[b] = __ldg(x + chunk * VEC + b);
  uint8_t* col = out + static_cast<long long>(chunk) * VEC;
  for (long long e = tid / nchunks; e < num_edges; e += kUnroll * stride) {
    uint32_t he[kUnroll] = {}, le[kUnroll] = {}, te[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long eu = e + u * stride;
      if (eu < num_edges) {
        he[u] = __ldg(h + eu);
        le[u] = __ldg(lo + eu);
        te[u] = __ldg(thr + eu);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long eu = e + u * stride;
      if (eu >= num_edges) break;
      uint8_t* dst = col + eu * num_samples;
      if constexpr (VEC == 16) {
        const uint4 v = make_uint4(sample_word<PRED>(he[u], le[u], te[u], xs),
                                   sample_word<PRED>(he[u], le[u], te[u], xs + 4),
                                   sample_word<PRED>(he[u], le[u], te[u], xs + 8),
                                   sample_word<PRED>(he[u], le[u], te[u], xs + 12));
        __stcs(reinterpret_cast<uint4*>(dst), v);
      } else {
        __stcs(reinterpret_cast<unsigned int*>(dst),
               sample_word<PRED>(he[u], le[u], te[u], xs));
      }
    }
  }
}

// at most one wave of resident blocks (the walk strides over the rest), and
// at least enough threads for one edge's chunks
template <int VEC>
int launch(int variant, const uint32_t* h, const uint32_t* lo, const uint32_t* thr,
           const uint32_t* x, uint8_t* out, long long num_edges, int num_samples,
           cudaStream_t s) {
  const auto kernel =
      variant == 0 ? fused_sample_kernel<0, VEC> : fused_sample_kernel<1, VEC>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long nchunks = num_samples / VEC;
  const long long work = num_edges * nchunks;
  long long blocks = (work + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const long long wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > wave) blocks = wave;
  const long long least = (nchunks + kThreads - 1) / kThreads;
  if (blocks < least) blocks = least;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(h, lo, thr, x, out, num_edges,
                                                           num_samples);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_fused_sample(const void* h, const void* lo,
                                  const void* thr, const void* x, void* out,
                                  long long num_edges, int num_samples,
                                  int variant, void* stream) {
  if (num_edges <= 0 || num_samples <= 0) return cudaGetLastError();
  if (variant != 0 && variant != 1) return cudaErrorInvalidValue;
  if (!rt::rows_aligned(num_samples, out, out)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* hh = static_cast<const uint32_t*>(h);
  const auto* ll = static_cast<const uint32_t*>(lo);
  const auto* tt = static_cast<const uint32_t*>(thr);
  const auto* xx = static_cast<const uint32_t*>(x);
  auto* o = static_cast<uint8_t*>(out);
  if (num_samples % 16 == 0 && rt::aligned16(out))
    return launch<16>(variant, hh, ll, tt, xx, o, num_edges, num_samples, s);
  return launch<4>(variant, hh, ll, tt, xx, o, num_edges, num_samples, s);
}
