// Ring-step bucket merges of the serial-ring backend, in place on acc:
//
//   propagate: for every live slot (w, r) of a bucket and register j where
//              the predicate fires, acc[w, j] = max(acc[w, j], block[r, j]);
//              VISITED entries of acc stay VISITED (sticky);
//   cascade:   where the predicate fires and block[r, j] is VISITED,
//              acc[w, j] = VISITED.
//
// The propagate merge replaces the Pallas kernel
// src/repro/kernels/bucket_propagate.py (bucket_propagate_pallas, body
// _bucket_kernel). The cascade merge is the twin the reference computes in
// jnp (core/distributed.py, _bucket_sweep_cascade) and numpy
// (partition/serial.py, _RingState.sweep_cascade); it has no Pallas kernel.
//
// A bucket's slots come grouped by write row w, as compressed rows made once
// per partition on the device (partition/serial.py, kernels/edges.py), with
// the padding slots dropped, and cut into work items of at most CHUNK slots
// (kernels/edges.py, WorkList). acc and block must not share memory (the
// wrappers check it). The changed flag is set when any word of acc changed.
//
// Both merges are items.cuh's work-item sweep in place (rt::item_sweep,
// IN_PLACE: self_in = out = acc, gather = block), with rt::Propagate (signed
// byte max, VISITED sticky through Propagate::finish) or rt::Cascade
// (VISITED OR). A warp takes an item of the bucket's list, so no bucket row
// (an R-MAT hub, 13 K slots at rmat:20) sets the launch's length; an item
// without slots (about two rows in three of a bucket) returns at once and
// its row keeps its bytes, which is right for a max or an OR merge; only
// changed words are stored; split rows go through the partial scratch and
// the combine launch. Bound on the H100: propagate by integer operations
// (the predicate on every (slot, register) pair), cascade by bytes (one
// VISITED test per (slot, 4-register word), the predicate only where the
// read register is VISITED); the kernels' own traffic is the gathers,
// slots x num_regs bytes.
#include "items.cuh"

extern "C" int repro_bucket_propagate(void* acc, const void* block, void* partial,
                                      const void* item_ptr, const void* item_row,
                                      const void* item_slot, const void* split_row,
                                      const void* split_ptr, const void* nbr,
                                      const void* h, const void* lo, const void* thr,
                                      const void* x, int num_items, int num_split,
                                      int num_regs, int variant, void* changed,
                                      void* stream) {
  return rt::launch_item_sweep<rt::Propagate, true>(
      acc, block, acc, partial, item_ptr, item_row, item_slot, split_row, split_ptr, nbr,
      h, lo, thr, x, num_items, num_split, num_regs, variant, changed, stream);
}

extern "C" int repro_bucket_cascade(void* acc, const void* block, void* partial,
                                    const void* item_ptr, const void* item_row,
                                    const void* item_slot, const void* split_row,
                                    const void* split_ptr, const void* nbr, const void* h,
                                    const void* lo, const void* thr, const void* x,
                                    int num_items, int num_split, int num_regs,
                                    int variant, void* changed, void* stream) {
  return rt::launch_item_sweep<rt::Cascade, true>(
      acc, block, acc, partial, item_ptr, item_row, item_slot, split_row, split_ptr, nbr,
      h, lo, thr, x, num_items, num_split, num_regs, variant, changed, stream);
}
