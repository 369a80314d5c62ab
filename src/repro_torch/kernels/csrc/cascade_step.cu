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
// row and cut into work items of at most item_edges edges (kernels/edges.py,
// made once per build; CHUNK = 256 by default), so R-MAT's in-degree hubs
// (39,415 edges at rmat:20) no longer set the sweep's length:
//  1. one warp takes one item (items.cuh, over common.cuh's walk_edges):
//     it gathers each edge's m_in[u, :] into a shared-memory ring by
//     cp.async ahead of the walk, and a lane evaluates the predicate only
//     where u holds a VISITED byte that v's row lacks so far;
//  2. an item that is its whole row writes out[v, :] and the changed flag;
//     an item of a split row writes its VISITED bytes to its own partial
//     slot;
//  3. a second launch ORs each split row's partials into m_in[v, :], writes
//     out[v, :] and sets the flag. OR is commutative, associative and
//     idempotent, so any split gives the same bytes; no atomics.
#include "items.cuh"

// The item walk is items.cuh's (rt::item_sweep, rt::Cascade), with
// self_in = gather = m_in.
extern "C" int repro_cascade_sweep(const void* m_in, void* out, void* partial,
                                   const void* item_ptr, const void* item_row,
                                   const void* item_slot, const void* split_row,
                                   const void* split_ptr, const void* nbr, const void* h,
                                   const void* lo, const void* thr, const void* x,
                                   int num_items, int num_split, int num_regs,
                                   int variant, void* changed, void* stream) {
  return rt::launch_item_sweep<rt::Cascade, false>(
      m_in, m_in, out, partial, item_ptr, item_row, item_slot, split_row, split_ptr, nbr,
      h, lo, thr, x, num_items, num_split, num_regs, variant, changed, stream);
}
