// FILL-SKETCHES (paper Alg. 1): out[r, j] = clz(register_hash(u, j +
// reg_offset, seed)) as int8, except where m_in[r, j] is VISITED, which is
// kept. Row r holds vertex u = r, or u = ids[r] where a row-id operand is
// given (int32 or int64): a mesh rank fills only the rows it owns, keyed on
// their original vertex ids.
//
// Replaces the Pallas kernel src/repro/kernels/sketch_fill.py
// (sketch_fill_pallas, body _sketch_fill_kernel).
//
// Bound on the H100: integer operations, a little ahead of bytes. It reads
// and writes n_rows * num_regs bytes (and one id a row) and does about 12
// integer operations per register (j * M2 as one add per register, the xor,
// fmix32's 8, clz, the byte pack); the VISITED merge is one operation per 4
// registers. Design: one block walks whole rows, so the vertex id (one load
// a row) and the per-row half of the hash are computed once per row; each
// thread moves one 32-bit word (4 registers) with coalesced loads and
// stores. __clz(0) = 32, as the reference's clz.
#include "common.cuh"

namespace {

// IdT: void for u = r, else the element type of the row ids
template <typename IdT>
__device__ __forceinline__ uint32_t row_vertex(const IdT* ids, int r) {
  return static_cast<uint32_t>(ids[r]);
}

template <>
__device__ __forceinline__ uint32_t row_vertex<void>(const void*, int r) {
  return static_cast<uint32_t>(r);
}

template <typename IdT>
__global__ void sketch_fill_kernel(const int8_t* __restrict__ m_in,
                                   int8_t* __restrict__ out,
                                   const IdT* __restrict__ ids, int n_rows,
                                   int num_regs, uint32_t reg_offset,
                                   uint32_t seed) {
  const int nwords = num_regs / 4;
  for (int r = blockIdx.x; r < n_rows; r += gridDim.x) {
    const long long off = static_cast<long long>(r) * num_regs;
    // register_hash(u, j) = mix32(mix32(u * GOLD + (seed ^ C)) ^ (j * M2))
    const uint32_t a =
        rt::mix32(row_vertex<IdT>(ids, r) * rt::kGold + (seed ^ 0x5BD1E995u));
    for (int w = threadIdx.x; w < nwords; w += blockDim.x) {
      uint32_t fresh = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t j = static_cast<uint32_t>(w * 4 + b) + reg_offset;
        const uint32_t clz = __clz(static_cast<int>(rt::mix32(a ^ (j * rt::kM2))));
        fresh |= clz << (8 * b);
      }
      const uint32_t prev = rt::load_word(m_in + off, w);
      rt::store_word(out + off, w, fresh | rt::visited_bytes(prev));
    }
  }
}

}  // namespace

// ids: null (row r is vertex r) or n_rows row ids of id_bytes (4 or 8) each
extern "C" int repro_sketch_fill(const void* m_in, void* out, const void* ids,
                                 int id_bytes, int n_rows, int num_regs,
                                 unsigned reg_offset, unsigned seed,
                                 void* stream) {
  if (n_rows <= 0 || num_regs <= 0) return cudaGetLastError();
  const int threads = 256;
  const int blocks = n_rows < 65536 ? n_rows : 65536;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const int8_t*>(m_in);
  auto* o = static_cast<int8_t*>(out);
  if (!rt::rows_aligned(num_regs, m_in, out)) return cudaErrorInvalidValue;
  if (ids == nullptr) {
    sketch_fill_kernel<void><<<blocks, threads, 0, s>>>(
        in, o, nullptr, n_rows, num_regs, reg_offset, seed);
  } else if (id_bytes == 4) {
    sketch_fill_kernel<int32_t><<<blocks, threads, 0, s>>>(
        in, o, static_cast<const int32_t*>(ids), n_rows, num_regs, reg_offset,
        seed);
  } else if (id_bytes == 8) {
    sketch_fill_kernel<long long><<<blocks, threads, 0, s>>>(
        in, o, static_cast<const long long*>(ids), n_rows, num_regs,
        reg_offset, seed);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
