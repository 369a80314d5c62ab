// num_sweeps Jacobi SIMULATE sweeps over one bucket: each sweep, for every
// slot (w, r) and register j where the predicate fires,
//   next[w, j] = max(next[w, j], cur[r, j]),
// starting from next = cur, VISITED entries kept; the first sweep reads
// m_in, the last one writes out.
//
// Replaces the Pallas kernel src/repro/kernels/fused_sweep.py
// (fused_sweep_pallas, body _fused_sweep_kernel). That kernel keeps an
// (n_pad, lane_tile) pane of the register matrix in VMEM across the sweeps,
// so the sweeps after the first read no device memory. On the H100 nothing
// that size stays on chip between sweeps: one sim shard's block at full
// width (n_loc x j_loc = 524,292 x 512 at rmat:20) is 256 MiB, five times
// the 50 MB L2, and a thread block that kept a slab of every row across the
// sweeps would leave most SMs idle (a grid of num_regs / 16 blocks). So
// fusing buys nothing here, and each sweep is a whole-card sweep instead:
// items.cuh's work-item sweep (rt::item_sweep, rt::Propagate; self_in =
// gather = cur, out = next) over the bucket's work list (kernels/edges.py,
// WorkList), one item launch and one combine launch a sweep, all on one
// stream with no host synchronisation between them. The stream order is
// the only barrier between sweeps: a grid-wide barrier inside one
// cooperative launch would save a few microseconds against sweeps of about
// a millisecond and cap the grid at one resident wave. The ping-pong pair
// (out, scratch) is chosen so that the last sweep lands in out. An item of
// an empty row (about two rows in three of a bucket) copies its row.
//
// Bound on the H100: integer operations (the predicate on every (slot,
// register) pair of every sweep), against compulsory bytes of one read of
// m_in, one write of out and the slots. The kernel's own traffic is the
// gathers, num_sweeps x slots x num_regs bytes, plus a read and a write of
// every row a sweep.
#include "items.cuh"

extern "C" int repro_fused_sweep(const void* m_in, void* out, void* scratch, void* partial,
                                 const void* item_ptr, const void* item_row,
                                 const void* item_slot, const void* split_row,
                                 const void* split_ptr, const void* nbr, const void* h,
                                 const void* lo, const void* thr, const void* x,
                                 int num_items, int num_split, int num_regs, int variant,
                                 int num_sweeps, void* changed, void* stream) {
  if (num_sweeps <= 0) return cudaGetLastError();
  for (int sweep = 0; sweep < num_sweeps; ++sweep) {
    // sweep i writes `out` when num_sweeps - 1 - i is even, else `scratch`,
    // and reads what sweep i - 1 wrote (m_in for the first)
    const void* cur = sweep == 0 ? m_in : ((num_sweeps - sweep) % 2 == 0 ? out : scratch);
    void* next = (num_sweeps - 1 - sweep) % 2 == 0 ? out : scratch;
    const int status = rt::launch_item_sweep<rt::Propagate, false>(
        cur, cur, next, partial, item_ptr, item_row, item_slot, split_row, split_ptr, nbr,
        h, lo, thr, x, num_items, num_split, num_regs, variant, changed, stream);
    if (status != 0) return status;
  }
  return cudaGetLastError();
}
