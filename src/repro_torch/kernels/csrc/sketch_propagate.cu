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
// edges come grouped by source row and cut into work items of at most
// item_edges edges (kernels/edges.py, made once per build; CHUNK = 256 by
// default, repro_torch.tune measures others). R-MAT's out-degrees are
// skewed (at rmat:20 the largest is 39,935, half the rows have none); a warp
// per row would make the hub's walk the sweep's length. Here:
//  1. one warp takes one item (items.cuh, over common.cuh's walk_edges):
//     it gathers each edge's m_in[v, :] into a shared-memory ring by
//     cp.async ahead of the walk, keeps the running max in registers
//     (__vmaxs4: four signed bytes at once; a byte whose edge does not fire
//     reads as VISITED, the max's identity) and writes its result once;
//  2. an item that is its whole row writes out[u, :] and the changed flag;
//     an item of a split row writes its partial row (m_in[u, :] merged with
//     its edges) to its own slot of a scratch the wrapper allocates;
//  3. a second launch merges each split row's partials (the max is
//     commutative, associative and idempotent, so any split of a row's edges
//     gives the same bytes), keeps VISITED, writes out[u, :] and sets the
//     flag. No atomics: the result is deterministic.
// The changed flag is set when any output word differs from its input word
// (the host reads it once per sweep).
#include "items.cuh"

// The item walk is items.cuh's (rt::item_sweep, rt::Propagate), with
// self_in = gather = m_in.
extern "C" int repro_propagate_sweep(const void* m_in, void* out, void* partial,
                                     const void* item_ptr, const void* item_row,
                                     const void* item_slot, const void* split_row,
                                     const void* split_ptr, const void* nbr,
                                     const void* h, const void* lo, const void* thr,
                                     const void* x, int num_items, int num_split,
                                     int num_regs, int variant, void* changed,
                                     void* stream) {
  return rt::launch_item_sweep<rt::Propagate, false>(
      m_in, m_in, out, partial, item_ptr, item_row, item_slot, split_row, split_ptr, nbr,
      h, lo, thr, x, num_items, num_split, num_regs, variant, changed, stream);
}
